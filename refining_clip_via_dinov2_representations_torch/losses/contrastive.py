"""Contrastive objectives as plain PyTorch functions: CLIP, SigLIP, CoCa,
CyCLIP and CLIP distillation.

The port of the JAX package's ``losses/contrastive.py``: ``cross_entropy``
(an fp32 log-softmax), ``clip_logits`` / ``clip_loss``, ``siglip_loss``,
``coca_loss``, ``cyclip_loss`` and ``distill_clip_loss``. ``group`` is a
``torch.distributed`` process group (the data axis): each rank passes its
own rows, and the JAX package's named-axis collectives become collectives
over the group.

* ``gather_features`` all-gathers the rows of every rank in rank order
  (``lax.all_gather(tiled=True)``) with gradients: the backward sums the
  cotangents of a rank's rows over every rank (``psum_scatter``), so the
  reference's ``gather_with_grad=True`` is the only behaviour.
* ``local_loss`` (what the train step uses): local rows against every
  rank's columns, labels ``arange(b) + b * rank``. Without it every rank
  forms the whole ``[W b, W b]`` matrix.
* SigLIP scores the local block, then the other ranks' text blocks as
  negatives by ``dist_impl``: ``shift`` (W - 1 hops of a one-way ring),
  ``bidir`` (two counter-rotating rings, plus one hop where W - 1 is odd),
  ``gather`` (one gathered ``[b, W b]`` product, the local block masked) or
  ``reduce`` (W masked all-reduce rounds). A ring hop is an autograd
  Function over ``dist.batch_isend_irecv`` whose backward sends the
  gradient the opposite way.

Each rank returns its own loss; the train step averages the losses and the
gradients over the ranks, so the gradient is that of the rank mean, as
``jax.grad`` of the JAX step's ``pmean``. Without a group the features are
used as they are.

Dtypes follow JAX's promotion: the exponentiated ``logit_scale`` is fp32, so
``logit_scale * features`` promotes bf16 features to fp32 before the logits
matmul, as ``jnp`` does for two non-weak arrays.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

SIGLIP_DIST_IMPLS = ("shift", "bidir", "gather", "reduce")


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean CE over rows with integer labels, computed in fp32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(1, labels[:, None].long())[:, 0].mean()


def group_rank_size(group) -> Tuple[int, int]:
    """(rank, world size) in ``group``; (0, 1) without one."""
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


class _GatherRows(torch.autograd.Function):
    """Every rank's rows, concatenated in rank order; the backward sums the
    cotangents over the ranks and keeps this rank's rows."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        rank, world = group_rank_size(group)
        ctx.rows, ctx.rank = x.shape[0], rank
        out = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(out, x.contiguous(), group=group)
        return torch.cat(out)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad.narrow(0, ctx.rank * ctx.rows, ctx.rows), None


class _AllReduceSum(torch.autograd.Function):
    """``psum``: the sum over the ranks; its backward is the sum of the
    cotangents."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def _exchange(x: torch.Tensor, group, shift: int) -> torch.Tensor:
    """``x`` sent to rank ``rank + shift``; returns what rank ``rank -
    shift`` sent (``lax.ppermute`` over the ring)."""
    if x.is_cuda and dist.get_backend(group) == "gloo":
        # gloo hands the device pointer to its socket and aborts the process
        # (torch 2.11 on the H100: chip_smoke.py's gloo probe)
        raise RuntimeError("SigLIP's shift and bidir rings send CUDA tensors point to point, "
                           "which gloo does not carry: use NCCL, or --loss-dist-impl gather "
                           "or reduce")
    rank, world = group_rank_size(group)
    dst = dist.get_global_rank(group, (rank + shift) % world)
    src = dist.get_global_rank(group, (rank - shift) % world)
    x = x.contiguous()
    out = torch.empty_like(x)
    reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, x, dst, group),
                                   dist.P2POp(dist.irecv, out, src, group)])
    for r in reqs:
        r.wait()
    return out


class _RingShift(torch.autograd.Function):
    """One ring hop; the gradient goes back the opposite way."""

    @staticmethod
    def forward(ctx, x, group, shift: int):
        ctx.group, ctx.shift = group, shift
        return _exchange(x, group, shift)

    @staticmethod
    def backward(ctx, grad):
        return _exchange(grad, ctx.group, -ctx.shift), None, None


def gather_features(image_features: torch.Tensor, text_features: torch.Tensor,
                    group=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The features of every rank, in rank order, with gradients. Without a
    group: as given."""
    if group is None:
        return image_features, text_features
    return _GatherRows.apply(image_features, group), _GatherRows.apply(text_features, group)


def _promoted(logit_scale: torch.Tensor, *features: torch.Tensor):
    dtype = torch.promote_types(logit_scale.dtype, features[0].dtype)
    return (logit_scale.to(dtype),) + tuple(f.to(dtype) for f in features)


def clip_logits(image_features: torch.Tensor, text_features: torch.Tensor,
                logit_scale: torch.Tensor, group=None, local_loss: bool = True):
    """(logits_per_image, logits_per_text, labels). Under a group with
    ``local_loss``: ``[b, W b]`` logits and labels offset by ``b * rank``;
    without ``local_loss``: the whole ``[W b, W b]`` matrix on every rank."""
    b = image_features.shape[0]
    if group is None:
        scale, img, txt = _promoted(logit_scale, image_features, text_features)
        labels = torch.arange(b, device=img.device)
        return (scale * img) @ txt.T, (scale * txt) @ img.T, labels
    all_img, all_txt = gather_features(image_features, text_features, group)
    if local_loss:
        scale, img, txt, a_img, a_txt = _promoted(logit_scale, image_features, text_features,
                                                  all_img, all_txt)
        rank, _ = group_rank_size(group)
        labels = torch.arange(b, device=img.device) + b * rank
        return (scale * img) @ a_txt.T, (scale * txt) @ a_img.T, labels
    scale, a_img, a_txt = _promoted(logit_scale, all_img, all_txt)
    logits_per_image = (scale * a_img) @ a_txt.T
    labels = torch.arange(a_img.shape[0], device=a_img.device)
    return logits_per_image, logits_per_image.T, labels


def clip_loss(image_features: torch.Tensor, text_features: torch.Tensor,
              logit_scale: torch.Tensor, group=None,
              local_loss: bool = True) -> torch.Tensor:
    """Symmetric InfoNCE; under a group, this rank's loss."""
    logits_i, logits_t, labels = clip_logits(image_features, text_features, logit_scale,
                                             group, local_loss)
    return 0.5 * (cross_entropy(logits_i, labels) + cross_entropy(logits_t, labels))


def _siglip_pair_loss(image_features: torch.Tensor, text_features: torch.Tensor,
                      logit_scale: torch.Tensor, logit_bias, negative_only: bool = False
                      ) -> torch.Tensor:
    """The pairwise sigmoid loss of one (image block, text block) pair:
    positives on the diagonal unless ``negative_only``."""
    scale, img, txt = _promoted(logit_scale, image_features, text_features)
    logits = (scale * img) @ txt.T
    if logit_bias is not None:
        logits = logits + logit_bias
    b = img.shape[0]
    labels = -torch.ones((b, b), dtype=logits.dtype, device=logits.device)
    if not negative_only:
        labels = labels + 2.0 * torch.eye(b, dtype=logits.dtype, device=logits.device)
    return -F.logsigmoid(labels * logits.float()).sum() / b


def siglip_loss(image_features: torch.Tensor, text_features: torch.Tensor,
                logit_scale: torch.Tensor, logit_bias, group=None,
                dist_impl: str = "shift") -> torch.Tensor:
    """SigLIP with the other ranks' text blocks as negatives (see the module
    docstring for ``dist_impl``); this rank's loss."""
    if dist_impl not in SIGLIP_DIST_IMPLS:
        raise ValueError(f"unknown dist_impl {dist_impl!r}")
    loss = _siglip_pair_loss(image_features, text_features, logit_scale, logit_bias)
    rank, n = group_rank_size(group)
    if n <= 1:
        return loss

    def negatives(block):
        return _siglip_pair_loss(image_features, block, logit_scale, logit_bias,
                                 negative_only=True)

    if dist_impl == "shift":
        block = text_features
        for _ in range(n - 1):
            block = _RingShift.apply(block, group, 1)
            loss = loss + negatives(block)
    elif dist_impl == "bidir":
        to_left = to_right = text_features
        num_bidir, remainder = divmod(n - 1, 2)
        for _ in range(num_bidir):
            from_right = _RingShift.apply(to_left, group, -1)
            from_left = _RingShift.apply(to_right, group, 1)
            for block in (from_right, from_left):
                loss = loss + negatives(block)
            to_left, to_right = from_right, from_left
        if remainder:
            loss = loss + negatives(_RingShift.apply(to_right, group, 1))
    elif dist_impl == "gather":
        all_text = _GatherRows.apply(text_features, group)
        scale, img, flat = _promoted(logit_scale, image_features, all_text)
        b = img.shape[0]
        logits = (scale * img) @ flat.T
        if logit_bias is not None:
            logits = logits + logit_bias
        # every gathered pair is a negative; the local block was scored above
        per_pair = -F.logsigmoid(-logits.float())
        col_mask = (torch.arange(n * b, device=logits.device) // b != rank).float()
        loss = loss + (per_pair * col_mask).sum() / b
    else:  # reduce: round i gives every rank rank i's block
        for i in range(n):
            mask = float(rank == i)
            block = _AllReduceSum.apply(text_features * mask, group)
            # rank i scores its own block as zero, but keeps the node, whose
            # backward is a collective every rank joins
            loss = loss + (0.0 if rank == i else 1.0) * negatives(block)
    return loss


def coca_loss(image_features: torch.Tensor, text_features: torch.Tensor,
              caption_logits: torch.Tensor, caption_labels: torch.Tensor,
              logit_scale: torch.Tensor, caption_loss_weight: float = 2.0,
              clip_loss_weight: float = 1.0, pad_id: int = 0, group=None,
              local_loss: bool = True) -> dict:
    """open_clip's ``CoCaLoss`` (``tpu/losses/contrastive.py:225-251``): the
    weighted CLIP term (local rows against the gathered columns under a
    group), and the caption cross-entropy over the labels that are not
    ``pad_id``, from an fp32 log-softmax, times ``caption_loss_weight``.
    Returns ``{"contrastive_loss", "caption_loss"}``."""
    contrastive = torch.zeros((), dtype=torch.float32, device=caption_logits.device)
    if clip_loss_weight:
        contrastive = clip_loss_weight * clip_loss(image_features, text_features, logit_scale,
                                                   group, local_loss)
    logp = torch.log_softmax(caption_logits.float(), dim=-1)  # [B, L, V]
    picked = logp.gather(-1, caption_labels[..., None].long())[..., 0]
    valid = (caption_labels != pad_id).float()
    caption = -(picked * valid).sum() / valid.sum().clamp(min=1.0)
    return {"contrastive_loss": contrastive, "caption_loss": caption_loss_weight * caption}


def _unit_fp32(x: torch.Tensor) -> torch.Tensor:
    x = x.float()
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-12)


def cyclip_loss(image_features: torch.Tensor, text_features: torch.Tensor,
                logit_scale: torch.Tensor, lambda_inmodal: float = 0.25,
                lambda_crossmodal: float = 0.25, group=None, local_loss: bool = True) -> dict:
    """The fork's ``CyCLIPLoss`` (``tpu/losses/contrastive.py:253-290``): the
    CLIP term plus the cyclic consistency penalties, the mean squared gaps
    between ``s_it`` and its transpose (cross-modal) and between ``s_ii``
    and ``s_tt`` (in-modal), over fp32 L2-normalised rows (floor 1e-12).
    Under a group with ``local_loss`` the penalties cover this rank's pairs
    only, the reference's own rule; without it, every rank's. Returns
    ``{"total_loss", "clip_loss", "inmodal_cyclic", "crossmodal_cyclic"}``."""
    base = clip_loss(image_features, text_features, logit_scale, group, local_loss)
    if group is not None and not local_loss:
        img, txt = gather_features(image_features, text_features, group)
    else:
        img, txt = image_features, text_features
    i, t = _unit_fp32(img), _unit_fp32(txt)
    s_ii, s_tt, s_it = i @ i.T, t @ t.T, i @ t.T
    l_cross = torch.square(s_it - s_it.T).mean()
    l_inmod = torch.square(s_ii - s_tt).mean()
    return {"total_loss": base + lambda_inmodal * l_inmod + lambda_crossmodal * l_cross,
            "clip_loss": base, "inmodal_cyclic": l_inmod, "crossmodal_cyclic": l_cross}


def distill_clip_loss(image_features: torch.Tensor, text_features: torch.Tensor,
                      logit_scale: torch.Tensor, dist_image_features: torch.Tensor,
                      dist_text_features: torch.Tensor, dist_logit_scale: torch.Tensor,
                      group=None, local_loss: bool = True) -> dict:
    """open_clip's ``DistillClipLoss`` (``tpu/losses/contrastive.py:293-319``):
    the CLIP term, and the soft cross-entropy of the student's logits
    against the softmax of the teacher's, both directions, each from fp32.
    The teacher's logits come from ``clip_logits`` with the same ``group``
    and ``local_loss`` as the student's. Returns ``{"contrastive_loss",
    "distill_loss"}``."""
    logits_i, logits_t, labels = clip_logits(image_features, text_features, logit_scale,
                                             group, local_loss)
    t_logits_i, t_logits_t, _ = clip_logits(dist_image_features, dist_text_features,
                                            dist_logit_scale, group, local_loss)
    contrastive = 0.5 * (cross_entropy(logits_i, labels) + cross_entropy(logits_t, labels))

    def soft_ce(teacher: torch.Tensor, student: torch.Tensor) -> torch.Tensor:
        q = torch.softmax(teacher.float(), dim=1)
        return -(q * torch.log_softmax(student.float(), dim=1)).sum(dim=1).mean()

    distill = 0.5 * (soft_ce(t_logits_i, logits_i) + soft_ce(t_logits_t, logits_t))
    return {"contrastive_loss": contrastive, "distill_loss": distill}
