#!/usr/bin/env python3
"""How far apart two bf16 train steps land when only the attention
implementation differs, on one CUDA card.

    python3 scripts/step_noise_floor.py

One DINO-soft step's loss and gradients (bf16 compute, seeded random batch,
the setup of ``chip_smoke.py``), each against plain attention, for two
batch seeds: at 577 vision tokens (ViT-L-14-336 and ViT-B-16 at 384 px,
batch 32) through the flash kernel, the flash kernel's plain version and the
fused kernels; at ViT-B-16's 197 tokens (batch 64, the train-step phase's)
through the fused kernels and their plain versions. Prints the loss
difference, the per-tensor gradient cosines (minimum, how many fall below
0.99, median) and the cosine of all tensors together. The pairs "plain
version vs plain attention" involve no kernel: they are the noise floor that
a kernel's pair is read against.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402

LONG_PATHS = (("flash kernel", "flash", False), ("flash plain version", "flash", True),
              ("fused kernels", "fused", False))
SHORT_PATHS = (("fused kernels", "fused", False), ("fused plain versions", "fused", True))
# (model, forced image size, batch, paths)
CASES = (("ViT-L-14-336", None, 32, LONG_PATHS), ("ViT-B-16", 384, 32, LONG_PATHS),
         ("ViT-B-16", None, 64, SHORT_PATHS))
SEEDS = (10, 11)


def step(model_name, impl, batch, size, plain=False):
    import torch

    with cs._plain_versions() if plain else contextlib.nullcontext():
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
    for model_name, size, n, paths in CASES:
        for seed in SEEDS:
            batch = cs._train_batch(get_tokenizer(model_name), n, "cuda",
                                    model_name=model_name, size=size, seed=seed)
            loss_p, grads_p = step(model_name, "xla", batch, size)
            for name, impl, plain in paths:
                loss, grads = step(model_name, impl, batch, size, plain)
                cos, together = cs._grad_cosines(grads, grads_p)
                vals = np.array(list(cos.values()))
                worst = min(cos, key=cos.get)
                print(f"{model_name} {size or 'native'} px, batch {n} seed {seed}, {name} vs "
                      f"plain attention: loss rel {abs(loss - loss_p) / abs(loss_p):.2e}; per tensor "
                      f"min {cos[worst]:.6f} at {worst}, {(vals < 0.99).sum()} of {len(vals)} "
                      f"below 0.99, median {np.median(vals):.6f}; all tensors together "
                      f"{together:.6f} [{card}]", flush=True)


if __name__ == "__main__":
    main()
