"""Param-group optimizers with tower locking, on the port's parameter names.

The port of the JAX package's ``train/optim.py``. Groups, with their lr and
weight decay:

  1. ``heads``: ``text_projection``, a ResNet's attention pool
     (``visual.attnpool.*``, its positional table too), every non-visual
     name containing "proj" (so every text-tower
     ``in_proj``/``out_proj``/``c_proj`` parameter) and the DINO projection
     head — ``head_lr``, wd 0;
  2. ``logit_scale``: ``logit_scale_lr``, wd 0;
  2b. ``resnet_l4`` and ``resnet_l3``: a ResNet's ``visual.layer4.*`` and
     ``visual.layer3.*`` — ``resnet_lr4`` and ``resnet_lr3`` (the fork's
     groups);
  3. ``text``: the unlocked text blocks (``--lock-text-unlocked-layers``),
     visual blocks whose index falls in that range too, and every
     ``token_embedding``/``positional_embedding`` (the visual one included)
     — ``text_lr``;
  4. ``default``: everything else — the base lr.

Those quirks are the reference's, kept for parity: it matches substrings of
parameter names. The JAX function matches JAX paths
(``model/text/transformer/resblocks_3/attn/in_proj_kernel``); here the same
rules are written for open_clip's names (``transformer.resblocks.3.attn.
in_proj_weight``; CoCa's text tower under ``text.``), and
``tests/test_torch_optim.py`` holds the two label sets equal leaf for leaf at
ViT-B-16 (``tests/test_torch_coca_train.py`` at a tiny CoCa).

Locking gives the label ``frozen``: such parameters belong to no param
group, so the optimizer neither moves nor decays them, but they keep
``requires_grad``. JAX clips by the global norm before the per-group
transform, so the norm includes the frozen leaves' gradients; the
optimizer clips over every parameter for the same reason.

The families of ``--opt`` (``make_inner_optimizer`` in the JAX package;
each name may carry the reference's ``timm/`` prefix), written as plain
torch on lists of tensors with optax 0.2.6's rounding points:

* ``adamw``: ``optax.adamw`` — the update from the fp32 moment; only the
  stored first moment is cast to ``mu_dtype`` (``--adam-mu-dtype``). Its
  decay ``b1 * mu`` takes b1 rounded to that dtype and the product in fp32,
  as the JAX package's jitted step computes it (``_decay_in``);
* ``lion``: ``optax.lion`` — the sign of ``(1-b1) g + b1 mu`` read from the
  stored (rounded) moment, then ``mu = (1-b2) g + b2 mu`` stored in
  ``mu_dtype``;
* ``lamb``: ``optax.lamb`` — Adam's direction plus decay, scaled per tensor
  by ``|p| / |u|`` (1 where either norm is zero); no ``mu_dtype``;
* ``adafactor``: ``optax.adafactor(learning_rate=None, momentum=beta1,
  dtype_momentum=mu_dtype or fp32, multiply_by_parameter_scale=False)``,
  then decoupled decay and the lr: the second moment factored into a row
  and a column statistic over a tensor's two largest dims where the
  smaller of them has at least 128 entries (decay ``1 - (t+1)^-0.8``, eps
  1e-30), the update clipped to block RMS 1, then a momentum of beta1;
  the factored dims follow the tensor's own shape, so for a square weight
  (stored transposed against the JAX kernel) the row and column
  statistics swap, which leaves the update the same;
* ``sgd`` / ``sgdw`` / ``momentum``: ``optax.trace(beta1)``, decay, lr
  (``--momentum`` is parsed and read by none, as in the JAX package).

Each update is ``p += -lr * (direction + wd * p)``. The head's parameters
are named ``dino_head.<name>`` here, as the JAX train tree holds them under
``dino_head``. ``GroupOptimizer.step(step)`` takes each group's lr as
``schedule(step) * group_lr / base_lr`` (or ``schedule(step)`` under
``flatten_group_lrs``), the value optax reads at the count before its
update. Tensors are updated in chunks of at most ``CHUNK`` elements with
``torch._foreach_*`` ops (adafactor and lamb tensor by tensor), so the
temporaries stay small beside the state. ``build_fused_optimizer`` is the
JAX package's fused AdamW: one flattened fp32 ``m`` and ``v`` per group.

Under ZeRO-1 or FSDP (``sharding``, a ``parallel/mesh.py:ParamSharding``)
each rank keeps the state of its dimension-0 slice of every split tensor
and updates that slice; ZeRO-1 then all-gathers the parameters. Under a
model axis each model rank holds its part of every TP-split tensor
(``parallel/tensor.py``) and the state of that part (layered under the
data split). What XLA computes over a whole tensor stays whole: the sums
of squares behind the global norm (clipping, ``grad_norm``) and lamb's
trust ratio, adafactor's row and column means over a split dimension, its
``row_col_mean`` and its block RMS are reduced over the ranks that hold
parts of the tensor (the data group for a data split, the model group for
a TP split; a replicated tensor counts once); adafactor factors by the
whole shape. ``state_dict`` gives the whole, unsplit state and
``load_state_dict`` takes it, so a checkpoint is the same file at any
``(data, model)``.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import re
from typing import Dict, Iterable, List, Mapping, Optional, Tuple

import torch

from ..models.convert import jax_positional_names
from ..parallel.tensor import Split, whole_shape
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
    # the reference's text-tower semantics (``train/main.py:text_tower_style``):
    # "clip" freezes the non-block text parameters under --lock-text and moves
    # the unlocked text blocks into the text group; "custom_text"
    # (CustomTextCLIP: the EVA configs) frees them unless no layer is
    # unlocked, and has no block loop
    text_tower_style: str = "clip"
    freeze_projection: bool = False  # bug-compatible: don't train the DINO head
    flatten_group_lrs: bool = False  # bug-compatible: scheduler overrides group LRs
    use_param_groups: bool = True    # False -> one group at the base lr
    # the stored first moment's dtype ("bfloat16"); None keeps the
    # parameters' dtype. The second moment stays in the parameters' dtype.
    mu_dtype: Optional[str] = None


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
    # CLIP's text blocks at top level; CustomTextCLIP's and CoCa's under text.
    return _block_index(r"(?:text\.)?transformer\.resblocks\.(\d+)\.", name)


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
    # the JAX rule reads the leaf's name: ViTamin's and MCi's ``pos_embed``
    positional = jax_positional_names(names)

    def label_one(p: str) -> str:
        is_text = p.split(".")[0] in _TEXT_PARTS + ("text",)
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
            elif cfg.text_tower_style == "clip" or n_unlock_text == 0:
                # CLIP.lock_text_tower freezes the non-block text params
                # always; TextTransformer.lock only at a full lock
                return "frozen"

        if p.startswith(HEAD_PREFIX):
            return "frozen" if cfg.freeze_projection else "heads"
        if "text_projection" in p:
            return "heads"
        if p.startswith("visual.attnpool."):  # the ResNet's pool, its positions too
            return "heads"
        # every "proj" outside the visual tower joins the heads group
        if "proj" in p and "visual" not in p:
            return "heads"
        if "logit_scale" in p:
            return "logit_scale"
        # the fork's ResNet groups (its main.py:577-601)
        if p.startswith("visual.layer4."):
            return "resnet_l4"
        if p.startswith("visual.layer3."):
            return "resnet_l3"
        if cfg.text_tower_style == "clip":  # the reference's block loop
            tb = _text_block(p)
            if tb is not None and tb >= text_start and n_unlock_text > 0:
                return "text"
            # the block selector "transformer.resblocks.{i}." also matches
            # visual blocks whose index falls in the unlocked text range
            vb = _vision_block(p)
            if vb is not None and n_unlock_text > 0 and text_start <= vb < text_layers:
                return "text"
        if "token_embedding" in p or "positional_embedding" in p or p in positional:
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


def clip_by_global_norm(grads: Iterable[torch.Tensor], max_norm: float,
                        norm: Optional[torch.Tensor] = None) -> None:
    """Scale the gradients in place by max_norm / norm where the norm is at
    least max_norm (optax's rule, with no epsilon); ``norm`` defaults to
    the gradients' global norm."""
    grads = list(grads)
    norm = global_norm(grads) if norm is None else norm
    factor = torch.where(norm < max_norm, torch.ones_like(norm), norm / max_norm)
    for g in grads:
        g.div_(factor.to(g.dtype))




FAMILIES = ("adamw", "lion", "lamb", "adafactor", "sgd")
_ALIASES = {"sgdw": "sgd", "momentum": "sgd"}
# the largest number of elements one chunk of foreach updates holds
CHUNK = 1 << 24
# adafactor's fixed settings (optax.adafactor's defaults)
AF_DECAY, AF_MIN_DIM, AF_EPS, AF_CLIP = 0.8, 128, 1e-30, 1.0


def optimizer_family(cfg: OptimCfg) -> str:
    """``cfg.opt`` without its ``timm/`` prefix, aliases resolved; the JAX
    package's errors for an unknown name and for lamb with a mu dtype."""
    name = (cfg.opt or "adamw").strip().lower().removeprefix("timm/")
    name = _ALIASES.get(name, name)
    if name not in FAMILIES:
        raise ValueError(
            f"unknown --opt {cfg.opt!r}: supported are 'adamw', 'lion', 'lamb', "
            "'adafactor', 'sgd' (optionally prefixed 'timm/' for reference-CLI "
            "compatibility)")
    if name == "lamb" and _mu_dtype(cfg.mu_dtype) is not None:
        raise ValueError("--adam-mu-dtype is not supported with --opt lamb "
                         "(optax.lamb keeps fp32 moments); unset one of them")
    return name


def _mu_dtype(name: Optional[str]) -> Optional[torch.dtype]:
    if name in (None, "float32"):
        return None
    if name == "bfloat16":
        return torch.bfloat16
    raise ValueError(f"mu_dtype {name!r}: 'float32' or 'bfloat16'")


def factored_dims(shape) -> Optional[Tuple[int, int]]:
    """optax's ``_factored_dims``: (second largest, largest) dim of a tensor
    of two or more dims whose second largest dim has at least 128 entries,
    ties in dim order; else None."""
    if len(shape) < 2:
        return None
    order = sorted(range(len(shape)), key=lambda i: shape[i])
    if shape[order[-2]] < AF_MIN_DIM:
        return None
    return order[-2], order[-1]


def _drop_dim(split: Optional[Split], dim: int) -> Optional[Split]:
    """The model-axis split of a statistic that reduces ``dim`` of a tensor
    split by ``split``: none where ``dim`` was the split one."""
    if split is None or split.dim == dim:
        return None
    return Split(split.dim - (1 if split.dim > dim else 0), split.packs)


def _bias_correction(decay: float, count: int) -> float:
    """``1 - decay ** count`` in fp32, as optax computes it."""
    return float(1 - torch.tensor(decay, dtype=torch.float32) ** count)


def _decay_in(tensors: List[torch.Tensor], decay: float) -> List[torch.Tensor]:
    """``decay * t`` in fp32 with the scalar rounded to each tensor's dtype:
    what the JAX package's jitted step computes for a weak-typed ``decay *
    mu`` with a bf16 ``mu`` (the literal is bf16; XLA keeps the product in
    fp32, as its excess-precision rule allows)."""
    if not tensors:
        return []
    scalar = float(torch.tensor(decay, dtype=tensors[0].dtype))
    if tensors[0].dtype == torch.float32:
        return torch._foreach_mul(tensors, scalar)
    return [t.float() * scalar for t in tensors]


def _chunks(tensors: List[torch.Tensor]) -> List[List[int]]:
    out, cur, n = [], [], 0
    for i, t in enumerate(tensors):
        if cur and n + t.numel() > CHUNK:
            out.append(cur)
            cur, n = [], 0
        cur.append(i)
        n += t.numel()
    if cur:
        out.append(cur)
    return out


class GroupOptimizer:
    """One ``--opt`` family with one param group per label, and what the JAX
    optimizer chains around it: clipping by the global norm of every
    gradient (frozen ones included) and the per-group schedule. The state
    is created with the optimizer, on each parameter's device; under
    ``sharding`` for this rank's slices only."""

    def __init__(self, params: Mapping[str, torch.nn.Parameter], labels: Dict[str, str],
                 cfg: OptimCfg, schedule: Schedule, base_lr: float, sharding=None):
        self.family = optimizer_family(cfg)
        self.cfg = cfg
        self.mu_dtype = _mu_dtype(cfg.mu_dtype)
        self.named = dict(params)
        self.params = list(params.values())
        self.schedule = schedule
        self.grad_clip_norm = cfg.grad_clip_norm
        self.sharding = sharding
        self.count = 0
        if not cfg.use_param_groups:
            group_wd, ratios = {"default": cfg.wd}, {"default": 1.0}
        else:
            lrs = group_base_lrs(cfg)
            group_wd = {g: cfg.wd if wd is None else wd for g, wd in GROUP_WD.items()}
            ratios = {g: 1.0 if cfg.flatten_group_lrs or base_lr <= 0 else lrs[g] / base_lr
                      for g in GROUP_WD}
        self.groups = []
        for g, wd in group_wd.items():
            names = [p for p, lbl in labels.items() if lbl == g]
            if names:
                self.groups.append({"label": g, "names": names, "wd": wd, "lr_ratio": ratios[g],
                                    "params": [params[n] for n in names]})
        # per state tensor: (whether it holds this data rank's dimension-0
        # slice, its model-axis split or None)
        self.split: Dict[str, Dict[str, Tuple[bool, Optional[Split]]]] = {}
        self.state = {n: self._init_state(n, params[n]) for grp in self.groups
                      for n in grp["names"]}

    def _split(self, name: str) -> bool:
        return self.sharding is not None and name in self.sharding.sharded

    def _tp(self, name: str) -> Optional[Split]:
        return None if self.sharding is None else self.sharding.tp_split(name)

    def _across(self, name: str) -> Tuple[bool, bool]:
        """(data, model): whether parameter ``name`` is split over each axis."""
        return self._split(name), self._tp(name) is not None

    def _whole_shape(self, name: str) -> tuple:
        shape = self.named[name].shape  # whole over the data axis (FSDP: the DTensor's)
        return tuple(shape) if self.sharding is None else self.sharding.whole_shape(name, shape)

    def _local(self, name: str, t: torch.Tensor) -> torch.Tensor:
        return t if self.sharding is None else self.sharding.local(name, t)

    def _init_state(self, name: str, p: torch.Tensor) -> Dict[str, torch.Tensor]:
        local = self._local(name, p.detach())
        split, tp = self._split(name), self._tp(name)
        zeros = lambda shape, dtype=None: torch.zeros(  # noqa: E731
            shape, dtype=dtype or local.dtype, device=local.device)
        if self.family in ("adamw", "lamb"):
            state = {"mu": zeros(local.shape, self.mu_dtype), "nu": zeros(local.shape)}
        elif self.family == "lion":
            state = {"mu": zeros(local.shape, self.mu_dtype)}
        elif self.family == "sgd":
            state = {"mu": zeros(local.shape)}
        else:  # adafactor: its momentum and second moment
            mu = zeros(local.shape, self.mu_dtype or torch.float32)
            dims = factored_dims(self._whole_shape(name))
            if dims is None:
                state = {"mu": mu, "v": zeros(local.shape)}
            else:
                d1, d0 = dims
                # a statistic keeps this rank's slice where it keeps dim 0,
                # and its model part where it keeps the TP-split dimension
                row = [n for i, n in enumerate(local.shape if d0 else p.shape) if i != d0]
                col = [n for i, n in enumerate(local.shape if d1 else p.shape) if i != d1]
                state = {"mu": mu, "v_row": zeros(row), "v_col": zeros(col)}
                self.split[name] = {"mu": (split, tp),
                                    "v_row": (split and d0 != 0, _drop_dim(tp, d0)),
                                    "v_col": (split and d1 != 0, _drop_dim(tp, d1))}
                return state
        self.split[name] = {k: (split, tp) for k in state}
        return state

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def grads(self):
        return [p.grad for p in self.params if p.grad is not None]

    def grad_norm(self) -> torch.Tensor:
        """The global norm of every gradient, in fp32, over the whole
        tensors (each part's sum of squares reduced over the ranks that
        hold parts of it; a replicated tensor counted once)."""
        if self.sharding is None:
            return global_norm(self.grads())
        names = [n for n, p in self.named.items() if p.grad is not None]
        sums = [(self._local(n, self.named[n].grad).float() ** 2).sum() for n in names]
        return torch.sqrt(sum(self._sum_over(sums, [self._across(n) for n in names])))

    def _sum_over(self, values: List[torch.Tensor], across: List[Optional[Tuple[bool, bool]]]
                  ) -> List[torch.Tensor]:
        """Each value, summed over the data and the model ranks where its
        ``across`` says so (one collective an axis for all of them)."""
        values = list(values)
        for data, model in ((True, False), (False, True), (True, True)):
            idx = [i for i, a in enumerate(across) if a == (data, model)]
            if idx:
                summed = self.sharding.sum_over(torch.stack([values[i].float() for i in idx]),
                                                data, model)
                for j, i in enumerate(idx):
                    values[i] = summed[j]
        return values

    @torch.no_grad()
    def step(self, step: int) -> None:
        """One update with the lr the schedule gives at ``step`` (counted
        from 0: the count optax reads before its update). A parameter of a
        group without a gradient takes a zero gradient, as an optax leaf."""
        if self.grad_clip_norm is not None:
            grads = [self._local(n, p.grad) for n, p in self.named.items() if p.grad is not None]
            clip_by_global_norm(grads, self.grad_clip_norm,
                                None if self.sharding is None else self.grad_norm())
        self.count += 1
        lr = self.schedule(step)
        update = getattr(self, f"_{self.family}")
        for group in self.groups:
            names = group["names"]
            ps = [self._local(n, p.detach()) for n, p in zip(names, group["params"])]
            gs = [self._local(n, p.grad) if p.grad is not None else torch.zeros_like(lp)
                  for n, p, lp in zip(names, group["params"], ps)]
            states = [self.state[n] for n in names]
            for idx in _chunks(ps):
                update([names[i] for i in idx], [ps[i] for i in idx], [gs[i] for i in idx],
                       [states[i] for i in idx], lr * group["lr_ratio"], group["wd"])
        if self.sharding is not None:
            self.sharding.gather_params(self.named)

    # ---- the families: each takes a chunk of names, parameters (this
    # rank's slices), gradients and states, the group's lr and weight
    # decay, and updates in place ----

    def _apply(self, ps, us, lr: float, wd: float) -> None:
        """``p += -lr * (u + wd * p)`` (optax's add_decayed_weights,
        scale_by_learning_rate and apply_updates)."""
        if wd:
            torch._foreach_add_(us, torch._foreach_mul(ps, wd))
        torch._foreach_mul_(us, -lr)
        torch._foreach_add_(ps, us)

    def _adam_direction(self, gs, states) -> List[torch.Tensor]:
        """scale_by_adam: ``mu_hat / (sqrt(nu_hat) + eps)`` from the fp32
        moment; the stored moment cast to its dtype."""
        c = self.cfg
        mus, nus = [s["mu"] for s in states], [s["nu"] for s in states]
        m = torch._foreach_mul(gs, 1 - c.beta1)
        torch._foreach_add_(m, _decay_in(mus, c.beta1))
        torch._foreach_copy_(mus, m)
        sq = torch._foreach_mul(gs, gs)
        torch._foreach_mul_(sq, 1 - c.beta2)
        torch._foreach_mul_(nus, c.beta2)
        torch._foreach_add_(nus, sq)
        del sq
        torch._foreach_div_(m, _bias_correction(c.beta1, self.count))
        den = torch._foreach_div(nus, _bias_correction(c.beta2, self.count))
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, c.eps)
        torch._foreach_div_(m, den)
        return m

    def _adamw(self, names, ps, gs, states, lr, wd) -> None:
        self._apply(ps, self._adam_direction(gs, states), lr, wd)

    def _lamb(self, names, ps, gs, states, lr, wd) -> None:
        us = self._adam_direction(gs, states)
        if wd:
            torch._foreach_add_(us, torch._foreach_mul(ps, wd))
        split = [self._across(n) for n in names]
        if any(any(s) for s in split):  # whole-tensor norms from each rank's part
            sq = [torch.stack([(p.float() ** 2).sum(), (u.float() ** 2).sum()]) if any(s)
                  else None for p, u, s in zip(ps, us, split)]
            sq = self._sum_over(sq, split)
        for i, (p, u) in enumerate(zip(ps, us)):  # scale_by_trust_ratio
            if any(split[i]):
                pn, un = torch.sqrt(sq[i][0]), torch.sqrt(sq[i][1])
            else:
                pn, un = torch.linalg.vector_norm(p), torch.linalg.vector_norm(u)
            u.mul_(torch.where((pn == 0) | (un == 0), torch.ones_like(pn), pn / un))
        self._apply(ps, us, lr, 0.0)

    def _lion(self, names, ps, gs, states, lr, wd) -> None:
        c = self.cfg
        mus = [s["mu"] for s in states]
        us = torch._foreach_mul(gs, 1 - c.beta1)
        torch._foreach_add_(us, _decay_in(mus, c.beta1))
        torch._foreach_sign_(us)
        m = torch._foreach_mul(gs, 1 - c.beta2)
        torch._foreach_add_(m, _decay_in(mus, c.beta2))
        torch._foreach_copy_(mus, m)
        del m
        self._apply(ps, us, lr, wd)

    def _sgd(self, names, ps, gs, states, lr, wd) -> None:
        traces = [s["mu"] for s in states]
        torch._foreach_mul_(traces, self.cfg.beta1)
        torch._foreach_add_(traces, gs)
        self._apply(ps, [t.clone() for t in traces], lr, wd)

    def _mean(self, t: torch.Tensor, dim: int, data: bool, model: bool, n: int,
              keepdim: bool = False) -> torch.Tensor:
        """``t.mean(dim)``; where ``dim`` is split over the data ranks
        (``data``) or the model ranks (``model``), the sum over every rank's
        part divided by the whole length ``n``."""
        if not (data or model):
            return t.mean(dim, keepdim=keepdim)
        return self.sharding.sum_over(t.sum(dim, keepdim=keepdim), data, model) / n

    def _adafactor(self, names, ps, gs, states, lr, wd) -> None:
        c = self.cfg
        # decay_rate_t = 1 - (t + 1)^-0.8 at the count t before this update,
        # in fp32 (a host number: no copy to the device, no wait for it)
        dr = float(1.0 - torch.tensor(float(self.count), dtype=torch.float32) ** -AF_DECAY)
        us = []
        for name, p, g, s in zip(names, ps, gs, states):
            split, tp = self._across(name)
            tp_dim = self._tp(name).dim if tp else None
            shape = self._whole_shape(name)
            sq = g * g + AF_EPS
            dims = factored_dims(shape)
            if dims is None:
                s["v"].copy_(dr * s["v"] + (1.0 - dr) * sq)
                u = g * s["v"] ** -0.5
            else:
                d1, d0 = dims
                row = self._mean(sq, d0, split and d0 == 0, tp_dim == d0, shape[d0])
                s["v_row"].copy_(dr * s["v_row"] + (1.0 - dr) * row)
                col = self._mean(sq, d1, split and d1 == 0, tp_dim == d1, shape[d1])
                s["v_col"].copy_(dr * s["v_col"] + (1.0 - dr) * col)
                reduced_d1 = d1 - 1 if d1 > d0 else d1
                row_col_mean = self._mean(s["v_row"], reduced_d1, split and d0 != 0 and d1 == 0,
                                          tp_dim == d1, shape[d1], keepdim=True)
                r = (s["v_row"] / row_col_mean) ** -0.5
                u = g * r.unsqueeze(d0) * (s["v_col"] ** -0.5).unsqueeze(d1)
            del sq
            # clip_by_block_rms, then the momentum (ema without debiasing)
            ms = (u * u).mean() if not (split or tp) else (
                self.sharding.sum_over((u * u).sum(), split, tp) / math.prod(shape))
            u = u / torch.clamp(torch.sqrt(ms) / AF_CLIP, min=1.0)
            mu = s["mu"]
            u = u * (1 - c.beta1) + _decay_in([mu], c.beta1)[0]
            mu.copy_(u)
            us.append(u)
        self._apply(ps, us, lr, wd)

    def state_dict(self, cpu_offload: bool = False) -> dict:
        """The whole state (each rank's slices gathered: a collective under
        a sharding, which every rank calls). ``cpu_offload``: each tensor is
        gathered in turn and copied to host memory by the writer alone
        (``parallel/mesh.py:is_writer``), the others get an empty
        ``state``."""
        from ..parallel.mesh import is_writer

        keep = not cpu_offload or is_writer()
        state = {}
        for n, s in self.state.items():
            for k, t in s.items():
                whole = t if self.sharding is None else self.sharding.gather_whole(
                    t, *self.split[n][k])
                if keep:
                    state.setdefault(n, {})[k] = (whole.to("cpu", copy=True) if cpu_offload
                                                  else whole)
                del whole  # freed before the next gather
        return {"family": self.family, "count": self.count, "state": state}

    def load_state_dict(self, state: dict) -> None:
        """Restores the whole state into the existing tensors (each keeps its
        dtype and device; a split one takes this rank's slice); raises on
        another family or another set of parameters."""
        if state.get("family") != self.family:
            raise ValueError(f"the saved optimizer state is {state.get('family')!r}, this run's "
                             f"optimizer is {self.family!r}")
        if set(state["state"]) != set(self.state):
            raise ValueError("the saved optimizer state holds other parameters than this run's")
        self.count = int(state["count"])
        for n, saved in state["state"].items():
            for k, t in self.state[n].items():
                src = saved[k]
                if self.sharding is not None:
                    data, split = self.split[n][k]
                    tp = self.sharding.tp
                    want = list(whole_shape(t.shape, split, tp.world if tp else 1))
                    if data:
                        want[0] *= self.sharding.world
                    if tuple(src.shape) != tuple(want):
                        raise ValueError(f"optimizer state {n}.{k}: saved {tuple(src.shape)}, "
                                         f"expected {tuple(want)}")
                    src = self.sharding.take_part(src, data, split)
                if tuple(src.shape) != tuple(t.shape):
                    raise ValueError(f"optimizer state {n}.{k}: saved {tuple(saved[k].shape)}, "
                                     f"expected {tuple(t.shape)}")
                t.copy_(src)


def build_optimizer(params: Mapping[str, torch.nn.Parameter], cfg: OptimCfg,
                    schedule: Schedule, base_lr: Optional[float] = None, sharding=None
                    ) -> Tuple[GroupOptimizer, Dict[str, str]]:
    """``cfg.opt`` with per-group lr and weight decay, global-norm clipping
    and frozen parameters in no group. ``params`` maps names (model keys,
    head keys under ``dino_head.``) to parameters; ``sharding`` (a
    ``parallel/mesh.py:ParamSharding``) splits the state over the ranks.
    Returns (optimizer, labels)."""
    base_lr = base_lr if base_lr is not None else (cfg.lr if cfg.lr is not None else 5e-5)
    labels = label_params(params, cfg)
    if not cfg.use_param_groups:
        labels = {p: "frozen" if lbl == "frozen" else "default" for p, lbl in labels.items()}
    sizes: Dict[str, int] = {}
    for p, lbl in labels.items():
        sizes[lbl] = sizes.get(lbl, 0) + params[p].numel()
    logging.info("optimizer groups: %s", sizes)
    return GroupOptimizer(params, labels, cfg, schedule, base_lr, sharding), labels


class FusedAdamW:
    """The JAX package's ``build_fused_optimizer``: AdamW with one flattened
    fp32 ``m`` and ``v`` per group (groups by label, whatever
    ``use_param_groups`` says, as there), the lr read at its own count
    before the update, ``-lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)``."""

    def __init__(self, params: Mapping[str, torch.nn.Parameter], labels: Dict[str, str],
                 cfg: OptimCfg, schedule: Schedule, base_lr: float):
        self.cfg = cfg
        self.params = list(params.values())
        self.schedule = schedule
        self.base_lr = base_lr
        self.grad_clip_norm = cfg.grad_clip_norm
        self.count = 0
        self.groups = {}
        for g in sorted({lbl for lbl in labels.values() if lbl != "frozen"}):
            members = [params[n] for n, lbl in labels.items() if lbl == g]
            n = sum(p.numel() for p in members)
            dev = members[0].device
            self.groups[g] = {"params": members,
                              "m": torch.zeros(n, dtype=torch.float32, device=dev),
                              "v": torch.zeros(n, dtype=torch.float32, device=dev)}

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def grads(self):
        return [p.grad for p in self.params if p.grad is not None]

    @torch.no_grad()
    def step(self, step: Optional[int] = None) -> None:
        """One update; the lr comes from the optimizer's own count, as in the
        JAX fused transform (``step`` is accepted for the train step's
        call and not read)."""
        c = self.cfg
        if self.grad_clip_norm is not None:
            clip_by_global_norm(self.grads(), self.grad_clip_norm)
        lr_now = self.schedule(self.count)
        self.count += 1
        lrs = group_base_lrs(c)
        bc1, bc2 = _bias_correction(c.beta1, self.count), _bias_correction(c.beta2, self.count)
        for g, st in self.groups.items():
            ps = st["params"]
            gv = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p))
                            .reshape(-1).float() for p in ps])
            pv = torch.cat([p.reshape(-1).float() for p in ps])
            st["m"].mul_(c.beta1).add_(gv * (1 - c.beta1))
            st["v"].mul_(c.beta2).add_(gv * gv * (1 - c.beta2))
            ratio = 1.0 if c.flatten_group_lrs or self.base_lr <= 0 else lrs[g] / self.base_lr
            lr = lr_now * ratio
            wd = GROUP_WD[g] if GROUP_WD[g] is not None else c.wd
            upd = st["m"] / bc1 / (torch.sqrt(st["v"] / bc2) + c.eps) + wd * pv
            upd.mul_(-lr)
            off = 0
            for p in ps:
                p.add_(upd[off:off + p.numel()].view_as(p).to(p.dtype))
                off += p.numel()

    def state_dict(self, cpu_offload: bool = False) -> dict:
        """The state; ``cpu_offload`` copies it to host memory."""
        host = (lambda t: t.to("cpu", copy=True)) if cpu_offload else (lambda t: t)  # noqa: E731
        return {"family": "fused_adamw", "count": self.count,
                "groups": {g: {"m": host(st["m"]), "v": host(st["v"])}
                           for g, st in self.groups.items()}}

    def load_state_dict(self, state: dict) -> None:
        if state.get("family") != "fused_adamw" or set(state["groups"]) != set(self.groups):
            raise ValueError("the saved optimizer state is not this fused AdamW's")
        self.count = int(state["count"])
        for g, saved in state["groups"].items():
            self.groups[g]["m"].copy_(saved["m"])
            self.groups[g]["v"].copy_(saved["v"])


def build_fused_optimizer(params: Mapping[str, torch.nn.Parameter], cfg: OptimCfg,
                          schedule: Schedule, base_lr: Optional[float] = None
                          ) -> Tuple[FusedAdamW, Dict[str, str]]:
    """AdamW over one flattened fp32 ``m``/``v`` per group; other families
    raise, as in the JAX package. Not on the CLI's path."""
    if (cfg.opt or "adamw").strip().lower().removeprefix("timm/") != "adamw":
        raise ValueError("build_fused_optimizer implements AdamW only; "
                         f"--opt {cfg.opt!r} must use build_optimizer")
    base_lr = base_lr if base_lr is not None else (cfg.lr if cfg.lr is not None else 5e-5)
    labels = label_params(params, cfg)
    return FusedAdamW(params, labels, cfg, schedule, base_lr), labels
