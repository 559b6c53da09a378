"""Param-group AdamW with tower locking, on the port's parameter names.

The port of the JAX package's ``train/optim.py`` for AdamW. Groups, with
their lr and weight decay:

  1. ``heads``: ``text_projection``, every non-visual name containing
     "proj" (so every text-tower ``in_proj``/``out_proj``/``c_proj``
     parameter) and the DINO projection head — ``head_lr``, wd 0;
  2. ``logit_scale``: ``logit_scale_lr``, wd 0;
  3. ``text``: the unlocked text blocks (``--lock-text-unlocked-layers``),
     visual blocks whose index falls in that range too, and every
     ``token_embedding``/``positional_embedding`` (the visual one included)
     — ``text_lr``;
  4. ``default``: everything else — the base lr.

Those quirks are the reference's, kept for parity: it matches substrings of
parameter names. The JAX function matches JAX paths
(``model/text/transformer/resblocks_3/attn/in_proj_kernel``); here the same
rules are written for open_clip's names (``transformer.resblocks.3.attn.
in_proj_weight``), and ``tests/test_torch_optim.py`` holds the two label
sets equal leaf for leaf at ViT-B-16.

Locking gives the label ``frozen``: such parameters belong to no param
group, so AdamW neither moves nor decays them, but they keep
``requires_grad``. JAX clips by the global norm before the per-group
transform, so the norm includes the frozen leaves' gradients; the train
step clips over every parameter for the same reason.

The head's parameters are named ``dino_head.<name>`` here, as the JAX
train tree holds them under ``dino_head``. ``GroupAdamW.step(step)``
sets each group's lr to ``schedule(step) * group_lr / base_lr`` (or
``schedule(step)`` under ``flatten_group_lrs``) before the update, which is
the value optax reads at the count before its update. Other optimizer
families and the fused AdamW raise.
"""

from __future__ import annotations

import dataclasses
import logging
import re
from typing import Dict, Iterable, Mapping, Optional, Tuple

import torch

from .scheduler import Schedule

HEAD_PREFIX = "dino_head."


@dataclasses.dataclass
class OptimCfg:
    lr: float = 5.0e-4
    beta1: float = 0.9
    beta2: float = 0.98
    eps: float = 1.0e-6
    wd: float = 0.2
    head_lr: float = 1.0e-4
    logit_scale_lr: float = 1.0e-6
    resnet_lr4: float = 2.0e-5
    resnet_lr3: float = 1.0e-5
    text_lr: float = 5.0e-5
    grad_clip_norm: Optional[float] = None
    opt: str = "adamw"
    lock_image: bool = False
    lock_image_unlocked_groups: int = 0
    lock_text: bool = False
    lock_text_unlocked_layers: int = 0
    freeze_projection: bool = False  # bug-compatible: don't train the DINO head
    flatten_group_lrs: bool = False  # bug-compatible: scheduler overrides group LRs
    use_param_groups: bool = True    # False -> one AdamW group at the base lr


GROUP_WD = {
    "heads": 0.0,
    "logit_scale": 0.0,
    "resnet_l4": None,  # None -> cfg.wd
    "resnet_l3": None,
    "text": None,
    "default": None,
}

_TEXT_PARTS = ("token_embedding", "positional_embedding", "transformer", "ln_final",
               "text_projection")


def _block_index(pattern: str, name: str) -> Optional[int]:
    m = re.match(pattern, name)
    return int(m.group(1)) if m else None


def _text_block(name: str) -> Optional[int]:
    return _block_index(r"transformer\.resblocks\.(\d+)\.", name)


def _vision_block(name: str) -> Optional[int]:
    return _block_index(r"visual\.transformer\.resblocks\.(\d+)\.", name)


def _count_blocks(names, block_of) -> int:
    return len({i for i in map(block_of, names) if i is not None})


def label_params(names: Iterable[str], cfg: OptimCfg, text_layers: Optional[int] = None,
                 vision_layers: Optional[int] = None) -> Dict[str, str]:
    """Each parameter name -> its group label. ``names`` are the model's
    state-dict keys plus the head's under ``dino_head.``."""
    names = list(names)
    if text_layers is None:
        text_layers = _count_blocks(names, _text_block)
    if vision_layers is None:
        vision_layers = _count_blocks(names, _vision_block)
    n_unlock_text = cfg.lock_text_unlocked_layers
    text_start = max(0, text_layers - n_unlock_text)

    def label_one(p: str) -> str:
        is_text = p.split(".")[0] in _TEXT_PARTS
        if cfg.lock_image and p.startswith("visual."):
            vb = _vision_block(p)
            g = cfg.lock_image_unlocked_groups
            if g <= 0:
                return "frozen"
            # the fork's lock: the last g blocks, ln_post and proj stay trainable
            unlocked = ((vb is not None and vb >= vision_layers - g)
                        or p.startswith("visual.ln_post") or p == "visual.proj")
            if not unlocked:
                return "frozen"
        if cfg.lock_text and is_text:
            tb = _text_block(p)
            if tb is not None:
                if tb < text_layers - n_unlock_text:
                    return "frozen"
            else:
                # CLIP.lock_text_tower freezes the non-block text params always
                return "frozen"

        if p.startswith(HEAD_PREFIX):
            return "frozen" if cfg.freeze_projection else "heads"
        if "text_projection" in p:
            return "heads"
        # every "proj" outside the visual tower joins the heads group
        if "proj" in p and "visual" not in p:
            return "heads"
        if "logit_scale" in p:
            return "logit_scale"
        tb = _text_block(p)
        if tb is not None and tb >= text_start and n_unlock_text > 0:
            return "text"
        # the block selector "transformer.resblocks.{i}." also matches visual
        # blocks whose index falls in the unlocked text range
        vb = _vision_block(p)
        if vb is not None and n_unlock_text > 0 and text_start <= vb < text_layers:
            return "text"
        if "token_embedding" in p or "positional_embedding" in p:
            return "text"  # the visual positional embedding too
        return "default"

    return {p: label_one(p) for p in names}


def group_base_lrs(cfg: OptimCfg) -> Dict[str, float]:
    base = cfg.lr if cfg.lr is not None else 5e-5
    return {
        "heads": cfg.head_lr,
        "logit_scale": cfg.logit_scale_lr,
        "resnet_l4": cfg.resnet_lr4,
        "resnet_l3": cfg.resnet_lr3,
        "text": cfg.text_lr,
        "default": base,
    }


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in fp32."""
    return torch.sqrt(sum((t.float() ** 2).sum() for t in tensors))


def clip_by_global_norm(grads: Iterable[torch.Tensor], max_norm: float) -> None:
    """Scale the gradients in place by max_norm / norm where the norm is at
    least max_norm (optax's rule, with no epsilon)."""
    grads = list(grads)
    norm = global_norm(grads)
    factor = torch.where(norm < max_norm, torch.ones_like(norm), norm / max_norm)
    for g in grads:
        g.div_(factor.to(g.dtype))


class GroupAdamW:
    """``torch.optim.AdamW`` with one param group per label, and what the
    JAX optimizer chains around AdamW: clipping by the global norm of every
    gradient (frozen ones included) and the per-group schedule."""

    def __init__(self, params: Mapping[str, torch.nn.Parameter], labels: Dict[str, str],
                 cfg: OptimCfg, schedule: Schedule, base_lr: float):
        self.params = list(params.values())
        self.schedule = schedule
        self.grad_clip_norm = cfg.grad_clip_norm
        if not cfg.use_param_groups:
            group_wd, ratios = {"default": cfg.wd}, {"default": 1.0}
        else:
            lrs = group_base_lrs(cfg)
            group_wd = {g: cfg.wd if wd is None else wd for g, wd in GROUP_WD.items()}
            ratios = {g: 1.0 if cfg.flatten_group_lrs or base_lr <= 0 else lrs[g] / base_lr
                      for g in GROUP_WD}
        groups = []
        for g, wd in group_wd.items():
            members = [params[p] for p, lbl in labels.items() if lbl == g]
            if members:
                groups.append({"params": members, "lr": base_lr * ratios[g],
                               "weight_decay": wd, "label": g, "lr_ratio": ratios[g]})
        self.adamw = torch.optim.AdamW(groups, lr=base_lr, betas=(cfg.beta1, cfg.beta2),
                                       eps=cfg.eps)

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def grads(self):
        return [p.grad for p in self.params if p.grad is not None]

    def step(self, step: int) -> None:
        """One update with the lr the schedule gives at ``step`` (counted
        from 0: the count optax reads before its update)."""
        if self.grad_clip_norm is not None:
            clip_by_global_norm(self.grads(), self.grad_clip_norm)
        lr = self.schedule(step)
        for group in self.adamw.param_groups:
            group["lr"] = lr * group["lr_ratio"]
        self.adamw.step()

    def state_dict(self) -> dict:
        return self.adamw.state_dict()

    def load_state_dict(self, state: dict) -> None:
        self.adamw.load_state_dict(state)


def build_optimizer(params: Mapping[str, torch.nn.Parameter], cfg: OptimCfg,
                    schedule: Schedule, base_lr: Optional[float] = None
                    ) -> Tuple[GroupAdamW, Dict[str, str]]:
    """AdamW with per-group lr and weight decay, global-norm clipping and
    frozen parameters in no group. ``params`` maps names (model keys, head
    keys under ``dino_head.``) to parameters. Returns (optimizer, labels)."""
    name = (cfg.opt or "adamw").strip().lower().removeprefix("timm/")
    if name != "adamw":
        raise NotImplementedError(f"--opt {cfg.opt!r}: the port has AdamW only so far")
    base_lr = base_lr if base_lr is not None else (cfg.lr if cfg.lr is not None else 5e-5)
    labels = label_params(params, cfg)
    if not cfg.use_param_groups:
        labels = {p: "frozen" if lbl == "frozen" else "default" for p, lbl in labels.items()}
    sizes: Dict[str, int] = {}
    for p, lbl in labels.items():
        sizes[lbl] = sizes.get(lbl, 0) + params[p].numel()
    logging.info("optimizer groups: %s", sizes)
    return GroupAdamW(params, labels, cfg, schedule, base_lr), labels


def build_fused_optimizer(*args, **kwargs):
    raise NotImplementedError("the fused AdamW of the JAX package is not ported")
