#!/usr/bin/env python3
"""The port's multi-GPU train step across cards: one process a card over
NCCL (or gloo ranks on the CPU, to rehearse).

    python3 scripts/dist_nccl_check.py [--nproc 4] [--device cuda|cpu]
        [--model ViT-B-16] [--batch 32] [--out PATH]

Starts ``--nproc`` ranks of ``chip_smoke.py``'s multi-rank step
(``chip_smoke.py:_child_step``; torchrun's variables, rank ``r`` on
``cuda:r``), each on a fresh copy of one seeded model for every case:

* clip and SigLIP (``shift``, ``bidir``, ``gather``, ``reduce``) under DDP,
  clip under ZeRO-1 and FSDP: the step at ``--batch`` rows a rank against
  the one-process step at the global batch on rank 0's card (the rank mean
  of these losses is the global batch's loss);
* the DINO-soft step (soft KL and weighted CE on each rank's block, the
  DINO head) under DDP, then under ZeRO-1 and FSDP against it.

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


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--nproc", type=int, default=4)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--model", default=cs.MODEL)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--out", default=None, help="write every rank's results here as JSON")
    args = p.parse_args()
    import torch

    if args.device == "cuda":
        if torch.cuda.device_count() < args.nproc:
            sys.exit(f"{args.nproc} ranks need {args.nproc} cards; "
                     f"{torch.cuda.device_count()} found")
        cs.phase_device()
        cs.phase_build()
    payload = {"cases": CASES, "model": args.model, "batch": args.batch, "device": args.device,
               "backend": "nccl" if args.device == "cuda" else "gloo", "time_one_process": True}
    ranks = cs._children("step", payload, args.nproc, timeout=900, per_card=True)
    lines, failed = cs.step_case_report(ranks, CASES,
                                        (24, 24) if args.device == "cuda" else (0, 0))
    for line in lines:
        print(line, flush=True)
    print(f"one process at {args.batch} rows: {ranks[0]['one_process_step_ms']:.1f} ms; "
          f"{args.nproc} ranks over {payload['backend']} ({cs.CARD})", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": cs.CARD, "world": args.nproc, "ranks": ranks, "failed": failed},
                      f, indent=1)
    print(json.dumps({"card": cs.CARD, "world": args.nproc, "failed": failed}), flush=True)
    if failed:
        sys.exit(1)


if __name__ == "__main__":
    main()
