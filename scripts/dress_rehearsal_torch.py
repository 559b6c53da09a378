"""Port-vs-JAX dress rehearsal: the thesis protocol through both training
CLIs on the procedural mini-Flickr set.

The JAX package's CLI, run as ``scripts/dress_rehearsal.py:run_tpu`` runs it,
stands in for the torch reference, and the PyTorch port's CLI
(``refining_clip_via_dinov2_representations_torch.train.main``) runs beside
it, each in a subprocess on the CPU, from one shared init on one dataset
(``scripts/mini_flickr.py``) with the flags of
``scripts/dress_rehearsal.py:_common_flags`` (DINO-soft fine-tune, CSV data
with the DINO join, pre-train and per-epoch retrieval evaluation, the
CLIP-blind check) plus ``--flatten-group-lrs`` in both. The shared
``init.pt`` is a seeded JAX ``mini-dress`` model exported with
``models/convert.py:flax_params_to_torch_state_dict``; both CLIs load it
with ``--pretrained``. The DINO projection head is not in it: each CLI draws
its own, from its own generator, and at this size that draw alone moves the
final recalls by more than their tolerance. So the port's run starts from
the head the JAX CLI draws (``jax_cli_head_init``), and both runs start from
the same weights.

Compared, with the tolerances of ``scripts/dress_rehearsal.py``:

1. epoch 0, the pre-train evaluation: the same weights through both eval
   pipelines, so recalls within ``EPOCH0_TOL`` and the average similarity,
   modality gap and val loss within ``EPOCH0_SCALAR_TOL``;
2. the final epoch: recalls within ``FINAL_RECALL_TOL`` and their mean
   within ``FINAL_RMEAN_TOL`` (the data order is the same, but the
   augmentation legitimately differs: the JAX CLI's is unseeded);
3. CLIP-blind relative percentages of every split both runs wrote, within
   ``BLIND_TOL``.

The first logged step's ``total_loss`` of both runs is printed beside them,
with its relative difference (one loader worker and one seed in both). The
offline suite (``eval/offline.py``) is not compared: it is not ported yet
(ROADMAP Queue 1 item 15).

Two rehearsals, one section of the report each:

* ``store``: the teacher features come from mini-Flickr's precomputed store
  (``--dino_fts_path`` and its val twin), as above.
* ``live``: no store; both CLIs load one seeded tiny DINOv2 directory in the
  HF layout (``transformers.Dinov2Model``, ``save_pretrained``) with
  ``--dino_model_name`` and run it live in the train step and the
  CLIP-blind check. It runs without the DINO head (``--no_projection``) and
  with a deterministic crop (the timm branch's RandomResizedCrop at scale
  and ratio 1 takes the whole image), so the two runs see the same pixels
  and start from the same weights; every step is logged, and the first
  step's ``soft_loss`` of both runs is reported beside its relative
  difference.

The report goes to ``--out`` (by default ``docs/dress_rehearsal_torch.md``);
the exit code is 0 only when every row of every rehearsal run is within its
tolerance.

Usage: python scripts/dress_rehearsal_torch.py [--mode store|live|both]
           [--workdir DIR] [--epochs N] [--n-train N] [--n-val N] [--seed S]
           [--out PATH]
"""

from __future__ import annotations

import json
import os
import platform
import re
import shutil
import subprocess
import sys
import time

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO_ROOT not in sys.path:
    sys.path.insert(0, REPO_ROOT)

from scripts.dress_rehearsal import (  # noqa: E402
    BLIND_TOL,
    EPOCH0_SCALAR_TOL,
    EPOCH0_TOL,
    FINAL_RECALL_TOL,
    FINAL_RMEAN_TOL,
    MINI_CFG,
    RECALL_KEYS,
    SCALAR_KEYS,
    _common_flags,
    load_clip_blind,
    load_itm_results,
)

# the precomputed-store flags of ``_common_flags``, each followed by a path
STORE_FLAGS = ("--dino_fts_path", "--dino_index_map_path", "--dino_fts_path_val",
               "--dino_index_map_path_val")
# the timm branch's RandomResizedCrop at scale and ratio 1 keeps the whole
# image: the same pixels in both CLIs, whose train crops draw from unseeded
# and differently seeded generators
DETERMINISTIC_CROP = ["--aug-cfg", "use_timm=True", "scale=(1.0,1.0)", "ratio=(1.0,1.0)"]


def prepare(workdir, n_train=160, n_val=40, seed=0, dino_dim=64):
    """The dataset, the model config file and the shared ``init.pt``.
    Returns the context dict the runs read."""
    import jax
    import jax.numpy as jnp
    import torch

    from refining_clip_via_dinov2_representations_tpu.models import (
        build_model,
        parse_model_cfg,
        register_model_config,
    )
    from refining_clip_via_dinov2_representations_tpu.models.convert import (
        flax_params_to_torch_state_dict,
    )
    from scripts.mini_flickr import generate

    data = generate(os.path.join(workdir, "data"), n_train=n_train, n_val=n_val,
                    size_px=MINI_CFG["vision_cfg"]["image_size"], dino_dim=dino_dim, seed=seed)
    cfg_dir = os.path.join(workdir, "cfg")
    os.makedirs(cfg_dir, exist_ok=True)
    cfg_path = os.path.join(cfg_dir, "mini-dress.json")
    with open(cfg_path, "w") as f:
        json.dump(MINI_CFG, f)
    register_model_config("mini-dress", MINI_CFG)

    cfg = parse_model_cfg(MINI_CFG)
    model = build_model(cfg)
    size = cfg.vision_cfg.image_size
    variables = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, size, size, 3)),
                           jnp.zeros((1, cfg.text_cfg.context_length), jnp.int32))
    sd = flax_params_to_torch_state_dict(jax.device_get(variables["params"]))
    init_path = os.path.join(workdir, "init.pt")
    torch.save({"state_dict": sd}, init_path)
    return {"data": data, "init": init_path, "workdir": workdir, "seed": seed,
            "cfg_path": cfg_path}


def jax_cli_head_init(ctx, path):
    """The DINO head the JAX CLI starts from (``tpu/train/main.py``: an MLP
    head to the store's width, ``init`` with ``PRNGKey(seed + 1)`` on a
    zero embedding), in the port's layout, saved to ``path``."""
    import jax
    import jax.numpy as jnp
    import torch

    from refining_clip_via_dinov2_representations_torch.models.convert import (
        jax_head_params_to_state_dict,
    )
    from refining_clip_via_dinov2_representations_tpu.losses.dino import (
        DinoProjectionHead as JaxHead,
    )

    dino_dim = torch.load(ctx["data"]["dino_feats"], weights_only=True).shape[1]
    params = JaxHead(dino_dim=dino_dim, projection_type="mlp").init(
        jax.random.PRNGKey(ctx["seed"] + 1), jnp.zeros((1, MINI_CFG["embed_dim"])))["params"]
    torch.save(jax_head_params_to_state_dict(jax.device_get(params)), path)
    return path


def tiny_teacher(path, seed=0):
    """A seeded tiny ``transformers.Dinov2Model`` (2 x 32, 4 heads, patch 14,
    a 2 x 2 position table) saved in the HF layout; both CLIPs' 64-px images
    reach it resized to 56 px, its table to 4 x 4. Its weights are drawn at
    std 0.2 (``initializer_range``): at HF's 0.02 every pair of mini-Flickr
    images has a teacher cosine above 0.99, and no pair could be CLIP-blind."""
    import torch
    from transformers import Dinov2Config, Dinov2Model

    torch.manual_seed(seed)
    Dinov2Model(Dinov2Config(hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
                             mlp_ratio=2, patch_size=14, image_size=28,
                             initializer_range=0.2)).save_pretrained(path)
    return path


def cli_flags(ctx, epochs, live):
    """``_common_flags``; for the live rehearsal without the store flags, with
    the teacher directory, no DINO head, the deterministic crop and every
    step logged."""
    flags = _common_flags(ctx, epochs)
    if not live:
        return flags
    kept, args = [], iter(flags)
    for f in args:
        if f in STORE_FLAGS:
            next(args)  # its path
        else:
            kept.append(f)
    return kept + ["--dino_model_name", ctx["teacher"], "--no_projection",
                   "--log-every-n-steps", "1"] + DETERMINISTIC_CROP


def run_cli(ctx, package, flags, logs, preamble=""):
    """``<package>.train.main`` in a subprocess on the CPU (the JAX one on
    one CPU device: in-process it would inherit the caller's device mesh),
    with ``--flatten-group-lrs`` (``scripts/dress_rehearsal.py:run_tpu``);
    ``preamble`` runs after the model config is registered."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO_ROOT + os.pathsep + env.get("PYTHONPATH", "")
    if package.endswith("_tpu"):
        env["JAX_PLATFORMS"] = "cpu"
        env["XLA_FLAGS"] = re.sub(r"--xla_force_host_platform_device_count=\d+", "",
                                  env.get("XLA_FLAGS", "")).strip()
    bootstrap = (
        "import json, sys\n"
        f"from {package}.models import register_model_config\n"
        f"register_model_config('mini-dress', json.load(open({ctx['cfg_path']!r})))\n"
        + preamble
        + f"from {package}.train.main import main\n"
        "main(sys.argv[1:])\n"
    )
    subprocess.run([sys.executable, "-c", bootstrap] + flags
                   + ["--flatten-group-lrs", "--logs", logs, "--name", "run", "--force-cpu"],
                   env=env, check=True, cwd=REPO_ROOT)
    return os.path.join(logs, "run")


def run_jax(ctx, flags):
    return run_cli(ctx, "refining_clip_via_dinov2_representations_tpu", flags,
                   os.path.join(ctx["workdir"], "jax_logs"))


def run_torch(ctx, flags):
    """The port's CLI with the JAX run's flags; with a DINO head, the head
    starts from the JAX CLI's (``jax_cli_head_init``: the two packages draw
    an init from different generators)."""
    preamble = ""
    if "--no_projection" not in flags:
        head_init = jax_cli_head_init(ctx, os.path.join(ctx["workdir"], "head_init.pt"))
        preamble = (
            "import torch\n"
            "from refining_clip_via_dinov2_representations_torch import losses\n"
            "class Head(losses.DinoProjectionHead):\n"
            "    def __init__(self, *a, **k):\n"
            "        super().__init__(*a, **k)\n"
            f"        self.load_state_dict(torch.load({head_init!r}, weights_only=True))\n"
            "losses.DinoProjectionHead = Head\n"
        )
    return run_cli(ctx, "refining_clip_via_dinov2_representations_torch", flags,
                   os.path.join(ctx["workdir"], "torch_logs"), preamble)


def first_logged(run_dir, key="total_loss"):
    """(step, value) of the first ``loss_steps.json`` record holding ``key``."""
    with open(os.path.join(run_dir, "loss_steps.json")) as f:
        first = next(r for r in json.load(f) if key in r)
    return first["step"], first[key]


def compare(jax_itm, torch_itm, jax_blind, torch_blind, epochs):
    """(rows, failures); a row is (section, metric, jax, port, |diff|, tol, ok)."""
    rows, failures = [], []

    def check(section, key, jv, tv, tol):
        delta = abs(float(jv) - float(tv))
        ok = delta <= tol
        rows.append((section, key, float(jv), float(tv), delta, tol, ok))
        if not ok:
            failures.append(f"{section}/{key}: jax={jv} port={tv} |diff|={delta:.4f} > {tol}")

    for section, epoch in (("epoch0", 0), ("final", epochs)):
        jm, tm = jax_itm.get(epoch), torch_itm.get(epoch)
        if jm is None or tm is None:
            failures.append(f"{section}: no epoch-{epoch} evaluation "
                            f"(jax {jm is not None}, port {tm is not None})")
            continue
        tol = EPOCH0_TOL if epoch == 0 else FINAL_RECALL_TOL
        for key in RECALL_KEYS:
            check(section, key, jm[key], tm[key], tol)
        if epoch == 0:
            for key in SCALAR_KEYS:
                check(section, key, jm[key], tm[key], EPOCH0_SCALAR_TOL)
        else:
            check(section, "r_mean", sum(jm[k] for k in RECALL_KEYS) / len(RECALL_KEYS),
                  sum(tm[k] for k in RECALL_KEYS) / len(RECALL_KEYS), FINAL_RMEAN_TOL)
    shared = sorted(set(jax_blind) & set(torch_blind))
    if not shared:
        failures.append("clip_blind: no split written by both runs")
    for split in shared:
        for key in sorted(set(jax_blind[split]) & set(torch_blind[split])):
            check(f"clip_blind/{split}", key, jax_blind[split][key], torch_blind[split][key],
                  BLIND_TOL)
    return rows, failures


def write_report(path, sections):
    """One markdown table per rehearsal (``rehearse``'s sections)."""
    lines = ["# Dress rehearsal — JAX CLI vs the PyTorch port's CLI", ""]
    for sec in sections:
        rows, failures = sec["rows"], sec["failures"]
        lines += [
            f"## {sec['title']}",
            "",
            "Written by `python scripts/dress_rehearsal_torch.py` "
            f"({'; '.join(f'{k} {v}' for k, v in sec['meta'].items())}).",
            "",
            "| section | metric | JAX | port | abs diff | tol | ok |",
            "|---|---|---|---|---|---|---|",
        ]
        for name, key, jv, tv, d, tol, ok in rows:
            lines.append(f"| {name} | {key} | {jv:.4f} | {tv:.4f} | {d:.4f} | {tol} |"
                         f" {'✓' if ok else '✗'} |")
        lines.append("| offline | (kNN, linear probe, geometry) | — | — | — | — | not "
                     "compared: `eval/offline.py` is not ported (ROADMAP Queue 1 item 15) |")
        lines += ["", f"**Result: {'PASS' if not failures else 'FAIL'}** "
                      f"({len(rows) - sum(not r[-1] for r in rows)}/{len(rows)} rows within "
                      "tolerance)"]
        lines += [f"- FAIL {f_}" for f_ in failures]
        lines += [""] + [f"- {n}" for n in sec["notes"]] + [""]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write("\n".join(lines))


def rehearse(workdir, epochs=3, n_train=160, n_val=40, seed=0, live=False):
    """Both runs of one rehearsal and their comparison: a report section."""
    t0 = time.perf_counter()
    for stale in ("data", "jax_logs", "torch_logs"):  # a .pt's .npy sidecar would be reused
        shutil.rmtree(os.path.join(workdir, stale), ignore_errors=True)
    ctx = prepare(workdir, n_train=n_train, n_val=n_val, seed=seed)
    if live:
        ctx["teacher"] = tiny_teacher(os.path.join(workdir, "teacher"), seed=seed)
    flags = cli_flags(ctx, epochs, live)
    t_jax = time.perf_counter()
    jax_dir = run_jax(ctx, flags)
    t_torch = time.perf_counter()
    torch_dir = run_torch(ctx, flags)
    t_end = time.perf_counter()
    rows, failures = compare(load_itm_results(jax_dir), load_itm_results(torch_dir),
                             load_clip_blind(jax_dir), load_clip_blind(torch_dir), epochs)
    key = "soft_loss" if live else "total_loss"
    (j_step, j_loss), (t_step, t_loss) = first_logged(jax_dir, key), first_logged(torch_dir, key)
    blind_splits = {"jax": sorted(load_clip_blind(jax_dir)),
                    "port": sorted(load_clip_blind(torch_dir))}
    notes = [
        f"first logged step: JAX step {j_step} {key} {j_loss:.6f}, port step {t_step} "
        f"{key} {t_loss:.6f}, relative difference {abs(t_loss - j_loss) / abs(j_loss):.3e} "
        + ("(the same pixels and weights in both: deterministic crop, no DINO head)" if live
           else "(one loader worker and seed in both; the JAX CLI's augmentation is unseeded)"),
        f"CLIP-blind splits written: JAX {blind_splits['jax']}, port {blind_splits['port']}"
        + (" (both from the live teacher)" if live else
           " (the JAX CLI's train split reads the train loader, which has no image paths, "
           "and logs a failure; the port reads an eval loader of the train CSV)"),
        f"wall time: {t_end - t0:.1f} s (set-up {t_jax - t0:.1f} s, JAX CLI "
        f"{t_torch - t_jax:.1f} s, port CLI {t_end - t_torch:.1f} s), on "
        f"{platform.machine()} with {os.cpu_count()} CPUs, {platform.python_implementation()} "
        f"{platform.python_version()}",
    ]
    title = ("Live DINOv2 teacher (seeded tiny HF directory, `--no_projection`, "
             "deterministic crop)" if live else "Precomputed teacher features")
    return {"title": title, "rows": rows, "failures": failures, "notes": notes,
            "meta": {"epochs": epochs, "n_train": n_train, "n_val": n_val, "seed": seed}}


def run_all(workdir, epochs=3, n_train=160, n_val=40, seed=0, out=None, live=False):
    """One rehearsal and its report; returns (rows, failures)."""
    sec = rehearse(workdir, epochs=epochs, n_train=n_train, n_val=n_val, seed=seed, live=live)
    write_report(out or os.path.join(workdir, "dress_rehearsal_torch.md"), [sec])
    return sec["rows"], sec["failures"]


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--mode", choices=["store", "live", "both"], default="both")
    p.add_argument("--workdir", default=os.path.join(REPO_ROOT, "build", "dress_rehearsal_torch"))
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--n-train", type=int, default=160)
    p.add_argument("--n-val", type=int, default=40)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=os.path.join(REPO_ROOT, "docs", "dress_rehearsal_torch.md"))
    a = p.parse_args(argv)
    sections = []
    for mode in (("store", "live") if a.mode == "both" else (a.mode,)):
        workdir = os.path.join(a.workdir, mode)
        os.makedirs(workdir, exist_ok=True)
        sections.append(rehearse(workdir, epochs=a.epochs, n_train=a.n_train, n_val=a.n_val,
                                 seed=a.seed, live=mode == "live"))
    write_report(a.out, sections)
    with open(a.out) as f:
        print(f.read())
    sys.exit(1 if any(sec["failures"] for sec in sections) else 0)


if __name__ == "__main__":
    main()
