"""Port-vs-JAX dress rehearsal: the thesis protocol through both training
CLIs on the procedural mini-Flickr set.

The JAX package's CLI (``scripts/dress_rehearsal.py:run_tpu``) stands in for
the torch reference, and the PyTorch port's CLI
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
(ROADMAP Queue 1 item 15). The table goes to ``--out`` (by default
``docs/dress_rehearsal_torch.md``); the exit code is 0 only when every row
is within its tolerance.

Usage: python scripts/dress_rehearsal_torch.py [--workdir DIR] [--epochs N]
           [--n-train N] [--n-val N] [--seed S] [--out PATH]
"""

from __future__ import annotations

import json
import os
import platform
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
    run_tpu,
)


def prepare(workdir, n_train=160, n_val=40, seed=0, dino_dim=64):
    """The dataset, the model config file and the shared ``init.pt``.
    Returns the context dict ``run_tpu`` reads."""
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


def run_torch(ctx, epochs):
    """The port's CLI in a subprocess on the CPU, with the JAX run's flags,
    its DINO head starting from the JAX CLI's head (``jax_cli_head_init``:
    the two packages draw an init from different generators)."""
    logs = os.path.join(ctx["workdir"], "torch_logs")
    head_init = jax_cli_head_init(ctx, os.path.join(ctx["workdir"], "head_init.pt"))
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO_ROOT + os.pathsep + env.get("PYTHONPATH", "")
    bootstrap = (
        "import json, sys, torch\n"
        "from refining_clip_via_dinov2_representations_torch import losses\n"
        "from refining_clip_via_dinov2_representations_torch.models import "
        "register_model_config\n"
        f"register_model_config('mini-dress', json.load(open({ctx['cfg_path']!r})))\n"
        "class Head(losses.DinoProjectionHead):\n"
        "    def __init__(self, *a, **k):\n"
        "        super().__init__(*a, **k)\n"
        f"        self.load_state_dict(torch.load({head_init!r}, weights_only=True))\n"
        "losses.DinoProjectionHead = Head\n"
        "from refining_clip_via_dinov2_representations_torch.train.main import main\n"
        "main(sys.argv[1:])\n"
    )
    flags = _common_flags(ctx, epochs) + ["--flatten-group-lrs", "--logs", logs, "--name", "run",
                                          "--force-cpu"]
    subprocess.run([sys.executable, "-c", bootstrap] + flags, env=env, check=True,
                   cwd=REPO_ROOT)
    return os.path.join(logs, "run")


def first_logged_loss(run_dir):
    """(step, total_loss) of the first ``loss_steps.json`` record."""
    with open(os.path.join(run_dir, "loss_steps.json")) as f:
        first = json.load(f)[0]
    return first["step"], first["total_loss"]


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


def write_report(path, rows, failures, meta, notes):
    lines = [
        "# Dress rehearsal — JAX CLI vs the PyTorch port's CLI",
        "",
        "Written by `python scripts/dress_rehearsal_torch.py` "
        f"({'; '.join(f'{k} {v}' for k, v in meta.items())}).",
        "",
        "| section | metric | JAX | port | abs diff | tol | ok |",
        "|---|---|---|---|---|---|---|",
    ]
    for sec, key, jv, tv, d, tol, ok in rows:
        lines.append(f"| {sec} | {key} | {jv:.4f} | {tv:.4f} | {d:.4f} | {tol} |"
                     f" {'✓' if ok else '✗'} |")
    lines.append("| offline | (kNN, linear probe, geometry) | — | — | — | — | not "
                 "compared: `eval/offline.py` is not ported (ROADMAP Queue 1 item 15) |")
    lines += ["", f"**Result: {'PASS' if not failures else 'FAIL'}** "
                  f"({len(rows) - sum(not r[-1] for r in rows)}/{len(rows)} rows within "
                  "tolerance)"]
    lines += [f"- FAIL {f_}" for f_ in failures]
    lines += [""] + [f"- {n}" for n in notes]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def run_all(workdir, epochs=3, n_train=160, n_val=40, seed=0, out=None):
    """Both runs, the comparison and the report; returns (rows, failures)."""
    t0 = time.perf_counter()
    for stale in ("data", "jax_logs", "torch_logs"):  # a .pt's .npy sidecar would be reused
        shutil.rmtree(os.path.join(workdir, stale), ignore_errors=True)
    ctx = prepare(workdir, n_train=n_train, n_val=n_val, seed=seed)
    t_jax = time.perf_counter()
    jax_dir = run_tpu(ctx, epochs)
    t_torch = time.perf_counter()
    torch_dir = run_torch(ctx, epochs)
    t_end = time.perf_counter()
    rows, failures = compare(load_itm_results(jax_dir), load_itm_results(torch_dir),
                             load_clip_blind(jax_dir), load_clip_blind(torch_dir), epochs)
    (j_step, j_loss), (t_step, t_loss) = first_logged_loss(jax_dir), first_logged_loss(torch_dir)
    blind_splits = {"jax": sorted(load_clip_blind(jax_dir)),
                    "port": sorted(load_clip_blind(torch_dir))}
    notes = [
        f"first logged step: JAX step {j_step} total_loss {j_loss:.6f}, port step {t_step} "
        f"total_loss {t_loss:.6f}, relative difference {abs(t_loss - j_loss) / abs(j_loss):.3e} "
        "(one loader worker and seed in both; the JAX CLI's augmentation is unseeded)",
        f"CLIP-blind splits written: JAX {blind_splits['jax']}, port {blind_splits['port']} "
        "(the JAX CLI's train split reads the train loader, which has no image paths, and "
        "logs a failure; the port reads an eval loader of the train CSV)",
        f"wall time: {t_end - t0:.1f} s (set-up {t_jax - t0:.1f} s, JAX CLI "
        f"{t_torch - t_jax:.1f} s, port CLI {t_end - t_torch:.1f} s), on "
        f"{platform.machine()} with {os.cpu_count()} CPUs, {platform.python_implementation()} "
        f"{platform.python_version()}",
    ]
    meta = {"epochs": epochs, "n_train": n_train, "n_val": n_val, "seed": seed}
    write_report(out or os.path.join(workdir, "dress_rehearsal_torch.md"), rows, failures,
                 meta, notes)
    return rows, failures


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workdir", default=os.path.join(REPO_ROOT, "build", "dress_rehearsal_torch"))
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--n-train", type=int, default=160)
    p.add_argument("--n-val", type=int, default=40)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=os.path.join(REPO_ROOT, "docs", "dress_rehearsal_torch.md"))
    a = p.parse_args(argv)
    os.makedirs(a.workdir, exist_ok=True)
    _, failures = run_all(a.workdir, epochs=a.epochs, n_train=a.n_train, n_val=a.n_val,
                          seed=a.seed, out=a.out)
    with open(a.out) as f:
        print(f.read())
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
