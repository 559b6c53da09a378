"""Zero-shot classifier construction.

The port of the JAX package's ``eval/zero_shot_classifier.py``: for each
class, every prompt template is filled in, tokenized and encoded
(``encode_text(normalize=True)``), the embeddings are averaged over the
templates and renormalised; classes go through the text tower
``num_classes_per_batch`` at a time (10 classes of the 80 OpenAI templates:
[800, 77] token batches, 12 fused-forward launches each for ViT-B-16 on a
card). The JAX package pads the last batch to keep one compiled shape; the
port runs it as it is (the rows are the same).
"""

from __future__ import annotations

from itertools import islice
from typing import Callable, Optional, Sequence, Union

import numpy as np
import torch


def _batched(iterable, n):
    it = iter(iterable)
    while batch := tuple(islice(it, n)):
        yield batch


def build_zero_shot_classifier(
    model: torch.nn.Module,
    tokenizer,
    classnames: Sequence[str],
    templates: Sequence[Union[Callable, str]],
    num_classes_per_batch: Optional[int] = 10,
    use_tqdm: bool = False,
) -> torch.Tensor:
    """[embed_dim, num_classes] classifier weights on the model's device,
    in its compute dtype (the mean and the norm too, as in the JAX
    package). ``templates`` are format strings or callables of the class
    name; ``num_classes_per_batch`` None or 0 encodes every class at once."""
    if not (isinstance(templates, Sequence) and len(templates) > 0):
        raise ValueError("templates must be a non-empty sequence")
    if not (isinstance(classnames, Sequence) and len(classnames) > 0):
        raise ValueError("classnames must be a non-empty sequence")
    use_format = isinstance(templates[0], str)
    num_templates = len(templates)
    device = next(model.parameters()).device

    def encode(batch_classnames) -> torch.Tensor:
        texts = [template.format(c) if use_format else template(c)
                 for c in batch_classnames for template in templates]
        ids = torch.from_numpy(np.asarray(tokenizer(texts))).long().to(device)
        with torch.no_grad():
            emb = model.encode_text(ids, normalize=True)
        emb = emb.reshape(-1, num_templates, emb.shape[-1]).mean(dim=1)
        return emb / emb.norm(dim=1, keepdim=True)

    if not num_classes_per_batch:
        return encode(tuple(classnames)).t()
    batches = list(_batched(classnames, num_classes_per_batch))
    if use_tqdm:
        import tqdm

        batches = tqdm.tqdm(batches)
    return torch.cat([encode(batch) for batch in batches], dim=0).t()


def build_zero_shot_classifier_legacy(
    model: torch.nn.Module,
    tokenizer,
    classnames: Sequence[str],
    templates: Sequence[Union[Callable, str]],
    use_tqdm: bool = False,
) -> torch.Tensor:
    """One class at a time."""
    return build_zero_shot_classifier(model, tokenizer, classnames, templates,
                                      num_classes_per_batch=1, use_tqdm=use_tqdm)
