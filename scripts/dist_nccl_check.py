#!/usr/bin/env python3
"""The port's multi-GPU train step across cards: one process a card over
NCCL (or gloo ranks on the CPU, to rehearse).

    python3 scripts/dist_nccl_check.py [--nproc 4] [--device cuda|cpu]
        [--model ViT-B-16] [--batch 32] [--eva-model EVA01-g-14]
        [--eva-batch 16] [--groups data tp tp-eva] [--out PATH]

Starts ``--nproc`` ranks of ``chip_smoke.py``'s multi-rank step
(``chip_smoke.py:_child_step``; torchrun's variables, rank ``r`` on
``cuda:r``), each on a fresh copy of one seeded model for every case:

* clip and SigLIP (``shift``, ``bidir``, ``gather``, ``reduce``) under DDP,
  clip under ZeRO-1 and FSDP: the step at ``--batch`` rows a rank against
  the one-process step at the global batch on rank 0's card (the rank mean
  of these losses is the global batch's loss);
* the DINO-soft step (soft KL and weighted CE on each rank's block, the
  DINO head) under DDP, then under ZeRO-1 and FSDP against it;
* ``tp``: on a ``(nproc / 2, 2)`` mesh (``--mesh-model-axis 2``: each model
  split over two cards of one host, the data axis across the pairs), the
  same model's clip step under DDP, ZeRO-1 and FSDP against the one-process
  step at the data axis's global batch, and the DINO-soft step under DDP,
  then ZeRO-1 and FSDP against it (24 + 24 launches a rank a step, at
  ``[b,6,197,64]`` and ``[b,4,77,64]``);
* ``tp-eva``: Config 5's multi-chip recipe, ``--eva-model`` (EVA01-g-14 at
  full width and depth) on the same mesh with Config 5's flags (grad
  checkpointing under ``dots_with_no_batch_dims_saveable``, adafactor with a
  bf16 first moment) under ZeRO-1, the clip step at ``--eva-batch`` rows a
  data rank against the one-process step at the global batch (104 + 52
  launches a rank a step: 40 vision and 12 text blocks, the forward twice
  with the recompute).

The checks are ``chip_smoke.py:step_case_report``'s: the first step's loss
at 1e-5 relative, every gradient whole after the rank mean at cosine >=
0.9999 (fp32, TF32 off), the fused kernels' launches a step on each rank
(24 + 24 at ViT-B-16; none on the CPU). Each case also gives every rank's
host clock of a second step and, on the cards, its peak memory over the
two steps and over the checkpoint's gather (model, head and optimizer state
into rank 0's host memory). Rank 0 also times the one-process step at
``--batch``, the per-card reference. Prints a line a case, the card's name
and power limit, then one JSON line (every rank's numbers also to
``--out``, where given); exits 1 when a check fails.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402

CASES = (("clip", "bidir", "replicated"), ("siglip", "shift", "replicated"),
         ("siglip", "bidir", "replicated"), ("siglip", "gather", "replicated"),
         ("siglip", "reduce", "replicated"), ("clip", "bidir", "zero1"),
         ("clip", "bidir", "fsdp"), ("dino", "bidir", "replicated"),
         ("dino", "bidir", "zero1"), ("dino", "bidir", "fsdp"))
TP_CASES = (("clip", "bidir", "replicated"), ("clip", "bidir", "zero1"),
            ("clip", "bidir", "fsdp"), ("dino", "bidir", "replicated"),
            ("dino", "bidir", "zero1"), ("dino", "bidir", "fsdp"))
EVA_CASES = (("clip", "bidir", "zero1"),)
CONFIG5 = {"remat": "dots_with_no_batch_dims_saveable",
           "optim": {"opt": "adafactor", "mu_dtype": "bfloat16"}}


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--nproc", type=int, default=4)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--model", default=cs.MODEL)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--eva-model", default="EVA01-g-14")
    p.add_argument("--eva-batch", type=int, default=16)
    p.add_argument("--groups", nargs="+", choices=["data", "tp", "tp-eva"],
                   default=["data", "tp", "tp-eva"])
    p.add_argument("--out", default=None, help="write every rank's results here as JSON")
    args = p.parse_args()
    import torch

    if args.device == "cuda":
        if torch.cuda.device_count() < args.nproc:
            sys.exit(f"{args.nproc} ranks need {args.nproc} cards; "
                     f"{torch.cuda.device_count()} found")
        cs.phase_device()
        cs.phase_build()
    cuda = args.device == "cuda"
    common = {"device": args.device, "backend": "nccl" if cuda else "gloo"}
    groups = {"data": ({**common, "cases": CASES, "model": args.model, "batch": args.batch,
                        "time_one_process": True}, (24, 24)),
              "tp": ({**common, "cases": TP_CASES, "model": args.model, "batch": args.batch,
                      "model_axis": 2}, (24, 24)),
              "tp-eva": ({**common, "cases": EVA_CASES, "model": args.eva_model,
                          "batch": args.eva_batch, "model_axis": 2, **CONFIG5}, (104, 52))}
    failed, out = [], {}
    for name in args.groups:
        payload, expect = groups[name]
        ranks = cs._children("step", payload, args.nproc, timeout=1200, per_card=True)
        lines, bad = cs.step_case_report(ranks, payload["cases"], expect if cuda else (0, 0))
        mesh = (f"({args.nproc // payload.get('model_axis', 1)}, "
                f"{payload.get('model_axis', 1)}) mesh")
        for line in lines:
            print(f"{name} {payload['model']} {mesh}: {line}", flush=True)
        if ranks[0]["one_process_step_ms"] is not None:
            print(f"one process at {payload['batch']} rows: "
                  f"{ranks[0]['one_process_step_ms']:.1f} ms", flush=True)
        print(f"{name}: {args.nproc} ranks over {payload['backend']} ({cs.CARD})", flush=True)
        failed += [f"{name} {f}" for f in bad]
        out[name] = ranks
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": cs.CARD, "world": args.nproc, "groups": out, "failed": failed},
                      f, indent=1)
    print(json.dumps({"card": cs.CARD, "world": args.nproc, "failed": failed}), flush=True)
    if failed:
        sys.exit(1)


if __name__ == "__main__":
    main()
