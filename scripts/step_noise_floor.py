#!/usr/bin/env python3
"""How far apart two bf16 train steps land when only the attention
implementation differs, on one CUDA card.

    python3 scripts/step_noise_floor.py

One DINO-soft step's loss and gradients (bf16 compute, batch 32, seeded
random batch, the setup of ``chip_smoke.py``) through the flash kernel, the
flash kernel's plain version and the fused kernels, each against plain
attention, for ViT-L-14-336 and ViT-B-16 at 384 px (577 vision tokens both)
and two batch seeds. Prints the loss difference, the per-tensor gradient
cosines (minimum, how many fall below 0.99, median) and the cosine of all
tensors together. The pair "flash plain version vs plain attention" involves
no kernel: it is the noise floor that a kernel's pair is read against.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402

CASES = (("ViT-L-14-336", None), ("ViT-B-16", 384))
PATHS = (("flash kernel", "flash", False), ("flash plain version", "flash", True),
         ("fused kernels", "fused", False))
BATCH, SEEDS = 32, (10, 11)


def step(model_name, impl, batch, size, plain_flash=False):
    import torch

    with cs._flash_plain_version() if plain_flash else contextlib.nullcontext():
        model, head, _, _, cfg = cs._dino_setup("bf16", impl, model_name=model_name,
                                                force_image_size=size)
        result = cs._loss_and_grads(model, head, cfg, batch)
    del model, head
    torch.cuda.empty_cache()
    return result


def main() -> None:
    import torch

    from refining_clip_via_dinov2_representations_torch.models import get_tokenizer

    if not torch.cuda.is_available():
        sys.exit("step_noise_floor: needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for model_name, size in CASES:
        for seed in SEEDS:
            batch = cs._train_batch(get_tokenizer(model_name), BATCH, "cuda",
                                    model_name=model_name, size=size, seed=seed)
            loss_p, grads_p = step(model_name, "xla", batch, size)
            for name, impl, plain_flash in PATHS:
                loss, grads = step(model_name, impl, batch, size, plain_flash)
                cos, together = cs._grad_cosines(grads, grads_p)
                vals = np.array(list(cos.values()))
                worst = min(cos, key=cos.get)
                print(f"{model_name} {size or 'native'} px, batch seed {seed}, {name} vs plain "
                      f"attention: loss rel {abs(loss - loss_p) / abs(loss_p):.2e}; per tensor "
                      f"min {cos[worst]:.6f} at {worst}, {(vals < 0.99).sum()} of {len(vals)} "
                      f"below 0.99, median {np.median(vals):.6f}; all tensors together "
                      f"{together:.6f} [{card}]", flush=True)


if __name__ == "__main__":
    main()
