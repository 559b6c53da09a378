"""Transformer towers: the vision ViT, the causal text transformer and
CoCa's multimodal decoder.

The port of the JAX package's ``models/transformer.py``: the ViT with every
variant the JAX module has (a class token or none, a learnable or fixed 2D
sine-cosine positional embedding, ``tok``/``avg`` pooling, ``ln_post``
before or after the pool, no ``ln_pre``, a biased patch embedding or
projection, no QKV bias, LayerScale, CoCa's attentional poolers; CLIPA's
and timm's GAP ViT are such towers); the causal text transformer with
argmax-EOT pooling or CoCa's appended CLS; the CoCa decoder; KV-cache
decode. (The SigLIP tower is ``models/siglip.py``, the relative-position
ViT ``models/relpos_vit.py``.) The text transformer's SigLIP and CLIPA
options: no causal mask, first/last pooling, a biased or no projection,
LayerNorm eps. Parameter names are open_clip's, so
``models/convert.py`` output loads with ``strict=True``.

Images are NHWC at the public boundary, as in the JAX package (NCHW is
accepted too and transposed once). The patch embedding, a convolution with
kernel = stride = patch, runs as a reshape and one matmul over the
``conv1.weight`` [width, 3, ph, pw] parameter: in fp32 that keeps it off
cuDNN's TF32 convolutions.

Activation checkpointing (``grad_checkpointing``) recomputes each residual
block in the backward under one of the JAX package's remat policies
(``tpu/models/transformer.py:46-72``, ``REMAT_POLICIES``):

* ``"full"``: keep only the block's input (``torch.utils.checkpoint``,
  non-reentrant), as ``nn.remat`` with no policy;
* ``"dots_saveable"`` / ``"dots_with_no_batch_dims_saveable"``: selective
  checkpointing (``create_selective_checkpoint_contexts``) that keeps the
  outputs of the matmul-class aten ops and recomputes the rest. A dot
  without a batch dimension is an ``mm``/``addmm`` (the blocks' linear
  projections); ``bmm``/``baddbmm`` (plain attention's products) have one,
  and only ``dots_saveable`` keeps them;
* ``"offload_dots_with_no_batch_dims"``: the same dots copied to pinned host
  memory in the forward and back to the device when the recompute reaches
  them (``_OffloadDots``): neither kept on the device nor recomputed.

The attention kernels are no dots here, as the ``pallas_call`` is none in
JAX: their ctypes launch is invisible to the dispatcher, so the autograd
Function runs again on every recompute, under every policy (one more
forward launch per block and step). Patch dropout draws outside the
checkpointed blocks, from the generator the caller passes
(``preserve_rng_state`` restores the global generators only).
"""

from __future__ import annotations

import functools
from collections import defaultdict
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from ..parallel.tensor import gather_from_model
from .layers import (MLP, AttentionalPooler, LayerNorm, LayerScale, MultiheadAttention,
                     PatchDropout, _linear, gelu)

REMAT_POLICIES = ("full", "dots_saveable", "dots_with_no_batch_dims_saveable",
                  "offload_dots_with_no_batch_dims")
_aten = torch.ops.aten
NO_BATCH_DOTS = frozenset({_aten.mm.default, _aten.addmm.default, _aten.mv.default,
                           _aten.addmv.default, _aten.dot.default})
BATCH_DOTS = frozenset({_aten.bmm.default, _aten.baddbmm.default})


def saved_ops(policy: str) -> frozenset:
    """The aten ops whose outputs a policy keeps (or offloads)."""
    if policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {policy!r}; one of {REMAT_POLICIES}")
    if policy == "full":
        return frozenset()
    if policy == "dots_saveable":
        return NO_BATCH_DOTS | BATCH_DOTS
    return NO_BATCH_DOTS


def selective_policy(policy: str) -> Callable:
    """The ``create_selective_checkpoint_contexts`` policy function: keep the
    outputs of ``saved_ops(policy)``, recompute everything else."""
    keep = saved_ops(policy)

    def policy_fn(ctx, op, *args, **kwargs):
        return CheckpointPolicy.MUST_SAVE if op in keep else CheckpointPolicy.PREFER_RECOMPUTE

    return policy_fn


class _OffloadDots(TorchDispatchMode):
    """One half of the offload policy's pair. In the forward (``restore``
    false) it copies each named dot's output to host memory (pinned when it
    comes from the card) behind the op; in the recompute it returns those
    copies, in order, on the device instead of running the dots again."""

    def __init__(self, ops: frozenset, storage: dict, restore: bool):
        super().__init__()
        self.ops, self.storage, self.restore = ops, storage, restore

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func not in self.ops:
            return func(*args, **kwargs)
        if self.restore:
            host, device = self.storage[func].pop(0)
            return host.to(device, non_blocking=True)
        out = func(*args, **kwargs)
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=out.is_cuda)
        host.copy_(out, non_blocking=True)
        self.storage[func].append((host, out.device))
        return out


def _offload_contexts(ops: frozenset):
    storage = defaultdict(list)
    return _OffloadDots(ops, storage, False), _OffloadDots(ops, storage, True)


def remat_kwargs(policy: str) -> dict:
    """``torch.utils.checkpoint.checkpoint``'s extra arguments for a policy."""
    ops = saved_ops(policy)
    if policy == "full":
        return {}
    if policy.startswith("offload"):
        return {"context_fn": functools.partial(_offload_contexts, ops)}
    return {"context_fn": functools.partial(create_selective_checkpoint_contexts,
                                            selective_policy(policy))}


def remat_args(grad_checkpointing: Union[bool, str]) -> Tuple[bool, str]:
    """``grad_checkpointing`` as the JAX factory takes it — a bool (full
    recompute when true) or a policy name — split into (enabled, policy)."""
    if isinstance(grad_checkpointing, str):
        return True, grad_checkpointing
    return bool(grad_checkpointing), "full"


class ResidualAttentionBlock(nn.Module):
    """Pre-LN block: ``x + ls_1(attn(ln_1(x)))`` then ``x + ls_2(mlp(ln_2(x)))``.

    A cross-attention block (``is_cross_attention``, the CoCa decoder's) has
    ``ln_1_kv`` over its keys and values. ``cache``/``pos`` run one decode
    step (returns ``(x, cache)``); ``static_kv`` attends over keys and
    values that ``cross_kv`` computed once (``tpu/models/transformer.py:
    75-139``)."""

    def __init__(self, width: int, n_head: int, mlp_ratio: float = 4.0,
                 ls_init_value: Optional[float] = None, act: Callable = gelu,
                 attn_impl: str = "auto", norm_eps: float = 1e-5,
                 is_cross_attention: bool = False, qkv_bias: bool = True):
        super().__init__()
        self.ln_1 = LayerNorm(width, norm_eps)
        self.ln_1_kv = LayerNorm(width, norm_eps) if is_cross_attention else None
        self.attn = MultiheadAttention(width, n_head, attn_impl, qkv_bias)
        self.ln_2 = LayerNorm(width, norm_eps)
        self.mlp = MLP(width, int(width * mlp_ratio), act)
        if ls_init_value is not None:
            self.ls_1 = LayerScale(width, ls_init_value)
            self.ls_2 = LayerScale(width, ls_init_value)
        else:
            self.ls_1 = self.ls_2 = None

    def cross_kv(self, kv: torch.Tensor):
        """The head-split (k, v) of ``ln_1_kv(kv)``, for ``static_kv``."""
        kv = self.ln_1_kv(kv)
        return self.attn(kv, kv=kv, return_kv=True)

    def forward(self, x: torch.Tensor, causal: bool = False,
                mask: Optional[torch.Tensor] = None, kv: Optional[torch.Tensor] = None,
                cache=None, pos: Optional[int] = None, static_kv=None):
        kv = None if kv is None or self.ln_1_kv is None else self.ln_1_kv(kv)
        new_cache = None
        if cache is not None:
            attn_out, new_cache = self.attn(self.ln_1(x), cache=cache, pos=pos)
        else:
            attn_out = self.attn(self.ln_1(x), causal=causal, kv=kv, mask=mask,
                                 static_kv=static_kv)
        if self.ls_1 is not None:
            attn_out = self.ls_1(attn_out)
        x = x + attn_out
        mlp_out = self.mlp(self.ln_2(x))
        if self.ls_2 is not None:
            mlp_out = self.ls_2(mlp_out)
        x = x + mlp_out
        return x if cache is None else (x, new_cache)


def run_blocks(blocks, x: torch.Tensor, remat: bool, remat_policy: str, **kwargs) -> torch.Tensor:
    """``x`` through each block with ``kwargs``, each block under
    ``torch.utils.checkpoint`` (non-reentrant: keyword tensors take their
    gradients too) with the policy's arguments where ``remat``."""
    extra = remat_kwargs(remat_policy) if remat else {}
    for blk in blocks:
        x = (checkpoint(blk, x, use_reentrant=False, **extra, **kwargs) if remat
             else blk(x, **kwargs))
    return x


class Transformer(nn.Module):
    """A stack of residual blocks. With ``grad_checkpointing`` on, a module
    in training under autograd runs each block under
    ``torch.utils.checkpoint`` (non-reentrant) with ``remat_policy``'s
    arguments (``remat_kwargs``): the block is recomputed in the backward,
    keeping only its input and what the policy saves, as the JAX package's
    ``nn.remat``. ``caches`` (one (k, v) per block) and ``pos`` run one
    decode step and return ``(x, caches)``; decode has no backward, so it
    never recomputes (``tpu/models/transformer.py:141-190``)."""

    def __init__(self, width: int, layers: int, heads: int, mlp_ratio: float = 4.0,
                 ls_init_value: Optional[float] = None, act: Callable = gelu,
                 attn_impl: str = "auto", grad_checkpointing: bool = False,
                 remat_policy: str = "full", norm_eps: float = 1e-5, qkv_bias: bool = True):
        super().__init__()
        saved_ops(remat_policy)  # raises on an unknown name
        self.grad_checkpointing = grad_checkpointing
        self.remat_policy = remat_policy
        self.resblocks = nn.ModuleList(
            ResidualAttentionBlock(width, heads, mlp_ratio, ls_init_value, act, attn_impl,
                                   norm_eps, qkv_bias=qkv_bias)
            for _ in range(layers)
        )

    def forward(self, x: torch.Tensor, causal: bool = False,
                mask: Optional[torch.Tensor] = None, caches=None, pos: Optional[int] = None):
        if caches is not None:
            new_caches = []
            for blk, cache in zip(self.resblocks, caches):
                x, cache = blk(x, cache=cache, pos=pos)
                new_caches.append(cache)
            return x, new_caches
        remat = self.grad_checkpointing and self.training and torch.is_grad_enabled()
        return run_blocks(self.resblocks, x, remat, self.remat_policy, causal=causal, mask=mask)


TEXT_POOL_TYPES = ("argmax", "first", "last")


def text_global_pool(x: torch.Tensor, text: Optional[torch.Tensor] = None,
                     pool_type: str = "argmax") -> torch.Tensor:
    """The text tower's pooling (``tpu/models/transformer.py:193-207``):
    ``"first"`` and ``"last"`` take that row; ``"argmax"`` each sequence's
    features at its highest token id, the EOT (the first one on ties, so
    all-zero padding rows pool at position 0)."""
    if pool_type == "first":
        return x[:, 0]
    if pool_type == "last":
        return x[:, -1]
    if pool_type != "argmax":
        raise ValueError(f"text pool_type {pool_type!r}: one of {TEXT_POOL_TYPES}")
    return x[torch.arange(x.shape[0], device=x.device), text.argmax(dim=-1)]


def project_text(pooled: torch.Tensor, proj) -> torch.Tensor:
    """The text projection: a [width, out] matrix, a biased ``Linear``
    (``proj_bias``), or none (``proj_type: "none"``)."""
    if proj is None:
        return pooled
    if isinstance(proj, nn.Linear):
        return _linear(pooled, proj)
    return pooled @ proj.to(pooled.dtype)


def get_2d_sincos_pos_embed(embed_dim: int, grid_size: int, cls_token: bool = False
                            ) -> np.ndarray:
    """The fixed 2D sine-cosine positional embedding [grid^2 (+1), dim] in
    fp32 (``tpu/models/transformer.py:get_2d_sincos_pos_embed``, open_clip's
    ``pos_embed.py:20-72``): computed in float64, the first half of each row
    from the column index, the second from the row index; a zero row first
    with ``cls_token``."""
    def one_d(dim: int, pos: np.ndarray) -> np.ndarray:
        omega = 1.0 / 10000 ** (np.arange(dim // 2, dtype=np.float64) / (dim / 2.0))
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    grid = np.arange(grid_size, dtype=np.float64)
    grid = np.stack(np.meshgrid(grid, grid), axis=0).reshape(2, 1, grid_size, grid_size)
    emb = np.concatenate([one_d(embed_dim // 2, grid[0]), one_d(embed_dim // 2, grid[1])],
                         axis=1)
    if cls_token:
        emb = np.concatenate([np.zeros((1, embed_dim)), emb], axis=0)
    return emb.astype(np.float32)


VISION_POOL_TYPES = ("tok", "avg", "none")


class VisionTransformer(nn.Module):
    """ViT tower: patch embed, the class token, the positional embedding,
    patch dropout (training, with a generator), ln_pre, transformer, ln_post
    and the pool, projection.

    The JAX module's options (``tpu/models/transformer.py:240-400``):
    ``no_ln_pre`` (no ``ln_pre``), ``proj_bias`` (``proj`` a biased Linear,
    timm's classifier head, instead of the [width, out] matrix),
    ``patch_embed_bias`` (a bias on ``conv1``), ``norm_eps`` (every
    LayerNorm's), ``class_token`` (False: no ``class_embedding``, the GAP
    trunks), ``qkv_bias``, ``pos_embed_type`` (``"learnable"``, or
    ``"sin_cos_2d"``: a fixed buffer outside the state dict, as the JAX tree
    has no such leaf; square grids only), ``pool_type`` (``"tok"``: the
    class token; ``"avg"``: the mean of the tokens after the class token,
    or of all without one; ``"none"``: every token) and
    ``final_ln_after_pool`` (``ln_post`` on the pooled row instead of every
    token). The EVA01 trunk (``models/eva.py``), CLIPA's towers and timm's
    ``vit_medium_patch16_gap_256`` are this tower with such options."""

    def __init__(self, image_size: Tuple[int, int] = (224, 224),
                 patch_size: Tuple[int, int] = (16, 16), width: int = 768,
                 layers: int = 12, heads: int = 12, mlp_ratio: float = 4.0,
                 ls_init_value: Optional[float] = None, output_dim: int = 512,
                 act: Callable = gelu, attn_impl: str = "auto",
                 compute_dtype: torch.dtype = torch.float32, grad_checkpointing: bool = False,
                 remat_policy: str = "full", patch_dropout: float = 0.0,
                 no_ln_pre: bool = False, proj_bias: bool = False,
                 patch_embed_bias: bool = False, norm_eps: float = 1e-5,
                 attentional_pool: Union[bool, str] = False, attn_pooler_queries: int = 256,
                 attn_pooler_heads: int = 8, output_tokens: bool = False,
                 class_token: bool = True, qkv_bias: bool = True,
                 pos_embed_type: str = "learnable", pool_type: str = "tok",
                 final_ln_after_pool: bool = False):
        super().__init__()
        if pool_type not in VISION_POOL_TYPES:
            raise ValueError(f"vision pool_type {pool_type!r}: one of {VISION_POOL_TYPES}")
        if pool_type == "tok" and not class_token:
            raise ValueError("pool_type 'tok' needs a class token")
        self.image_size = tuple(image_size)
        self.patch_size = tuple(patch_size)
        self.grid_size = (image_size[0] // patch_size[0], image_size[1] // patch_size[1])
        self.width = width
        self.compute_dtype = compute_dtype
        self.pool_type, self.final_ln_after_pool = pool_type, final_ln_after_pool
        self.conv1 = nn.Conv2d(3, width, kernel_size=self.patch_size,
                               stride=self.patch_size, bias=patch_embed_bias)
        self.class_embedding = nn.Parameter(torch.zeros(width)) if class_token else None
        n_pos = self.grid_size[0] * self.grid_size[1] + (1 if class_token else 0)
        if pos_embed_type == "learnable":
            self.positional_embedding = nn.Parameter(torch.zeros(n_pos, width))
        elif pos_embed_type == "sin_cos_2d":
            if self.grid_size[0] != self.grid_size[1]:
                raise ValueError("sin_cos_2d pos embedding only supports square input")
            self.register_buffer("positional_embedding", torch.from_numpy(
                get_2d_sincos_pos_embed(width, self.grid_size[0], cls_token=class_token)),
                persistent=False)
        else:
            raise ValueError(f"pos_embed_type {pos_embed_type!r}: learnable or sin_cos_2d")
        self.patch_dropout = PatchDropout(patch_dropout) if patch_dropout > 0 else None
        self.ln_pre = None if no_ln_pre else LayerNorm(width, norm_eps)
        self.transformer = Transformer(width, layers, heads, mlp_ratio, ls_init_value,
                                       act, attn_impl, grad_checkpointing, remat_policy,
                                       norm_eps, qkv_bias)
        self.output_tokens = output_tokens
        self.attentional_pool = attentional_pool
        self.attn_pool = self.attn_pool_contrastive = None
        pool_dim = width
        if attentional_pool:
            if isinstance(attentional_pool, str) and attentional_pool not in ("parallel",
                                                                               "cascade"):
                raise ValueError(f"attentional_pool {attentional_pool!r}: True, 'parallel' "
                                 "or 'cascade'")
            self.attn_pool = AttentionalPooler(output_dim, width, attn_pooler_heads,
                                               attn_pooler_queries)
            if isinstance(attentional_pool, str):
                # the CoCa paper's pooling: ln_post on the trunk's tokens, a
                # one-query pooler over them (parallel) or over the pooled
                # tokens (cascade)
                self.attn_pool_contrastive = AttentionalPooler(
                    output_dim, width if attentional_pool == "parallel" else output_dim,
                    attn_pooler_heads, 1)
            else:
                pool_dim = output_dim  # open_clip's CoCa: ln_post after the pooler
        self.ln_post = LayerNorm(pool_dim, norm_eps)
        pooled_dim = output_dim if attentional_pool else width
        self.proj = (nn.Linear(pooled_dim, output_dim) if proj_bias
                     else nn.Parameter(torch.zeros(pooled_dim, output_dim)))

    def set_grad_checkpointing(self, enable: bool = True) -> None:
        self.transformer.grad_checkpointing = enable

    def _global_pool(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(pooled, tokens) by ``pool_type`` (``tpu/models/transformer.py:
        330-338``)."""
        if self.pool_type == "avg":
            if self.class_embedding is None:
                return x.mean(dim=1), x
            return x[:, 1:].mean(dim=1), x[:, 1:]
        if self.pool_type == "tok":
            return x[:, 0], x[:, 1:]
        return x, x

    def _patch_embed(self, x: torch.Tensor) -> torch.Tensor:
        """[B, H, W, 3] -> [B, gh*gw, width], the stride-patch convolution
        as a matmul over (channel, row, col)-ordered patches."""
        b = x.shape[0]
        (gh, gw), (ph, pw) = self.grid_size, self.patch_size
        patches = x.reshape(b, gh, ph, gw, pw, 3).permute(0, 1, 3, 5, 2, 4)
        patches = patches.reshape(b, gh * gw, 3 * ph * pw)
        out = patches @ self.conv1.weight.to(x.dtype).reshape(self.width, -1).t()
        return out if self.conv1.bias is None else out + self.conv1.bias.to(x.dtype)

    def forward(self, x: torch.Tensor,
                patch_dropout_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if x.shape[1] == 3 and x.shape[-1] != 3:
            x = x.permute(0, 2, 3, 1)  # accept NCHW at the boundary
        if tuple(x.shape[1:3]) != self.image_size:
            raise ValueError(f"expected {self.image_size} images, got {tuple(x.shape)}")
        dtype = self.compute_dtype
        x = self._patch_embed(x.to(dtype))
        if self.class_embedding is not None:
            cls = self.class_embedding.to(dtype).expand(x.shape[0], 1, -1)
            x = torch.cat([cls, x], dim=1)
        x = x + self.positional_embedding.to(dtype)
        if self.patch_dropout is not None:
            x = self.patch_dropout(x, patch_dropout_generator)
        if self.ln_pre is not None:
            x = self.ln_pre(x)
        x = self.transformer(x)
        if self.attn_pool_contrastive is not None:  # "parallel" / "cascade"
            x = self.ln_post(x)
            tokens = self.attn_pool(x)
            pooled = self.attn_pool_contrastive(
                x if self.attentional_pool == "parallel" else tokens)[:, 0]
        elif self.attn_pool is not None:  # open_clip's CoCa pooling
            pooled, tokens = self._global_pool(self.ln_post(self.attn_pool(x)))
        elif self.final_ln_after_pool:
            pooled, tokens = self._global_pool(x)
            pooled = self.ln_post(pooled)
        else:
            pooled, tokens = self._global_pool(self.ln_post(x))
        if isinstance(self.proj, nn.Linear):
            pooled = _linear(pooled, self.proj)
        else:
            pooled = pooled @ self.proj.to(pooled.dtype)
        return (pooled, tokens) if self.output_tokens else pooled


def embed_tokens(emb: nn.Embedding, text: torch.Tensor) -> torch.Tensor:
    """The token rows of ``text``: a width-split table (``parallel/tensor.py``)
    looks up this rank's columns and gathers the others'."""
    return gather_from_model(emb(text), getattr(emb, "tp", None))


def encode_text_tokens(tower: nn.Module, text: torch.Tensor) -> torch.Tensor:
    """The text-tower forward over a module holding its parts
    (``token_embedding``, ``positional_embedding``, ``transformer``,
    ``ln_final``, ``text_projection``, ``compute_dtype``, ``causal``,
    ``pool_type``): a ``TextTransformer``, or a ``CLIP``, which holds them at
    top level as open_clip's CLIP does. A non-causal tower (SigLIP's) takes
    no mask at all, so its attention reaches the fused kernel with
    ``causal=False``."""
    dtype = tower.compute_dtype
    x = embed_tokens(tower.token_embedding, text).to(dtype)
    x = x + tower.positional_embedding[: text.shape[1]].to(dtype)
    x = tower.ln_final(tower.transformer(x, causal=tower.causal))
    pooled = text_global_pool(x, text, tower.pool_type)
    return project_text(pooled, tower.text_projection)


class TextTransformer(nn.Module):
    """Text transformer (``tpu/models/transformer.py:418-575``): causal with
    argmax-EOT pooling by default; ``no_causal_mask`` (no mask at all),
    ``pool_type`` ``"first"``/``"last"``/``"argmax"``, a biased ``Linear``
    projection (``proj_bias``) or none (``proj_type="none"``) and
    ``norm_eps`` (every LayerNorm's) are SigLIP's options. With
    ``embed_cls`` CoCa's tower: a learned CLS appended at the end, an
    additive mask of the causal rule plus ``_cls_mask`` (so the tower takes
    the plain attention, as in JAX), the CLS row pooled then ``ln_final``,
    and the other rows as its tokens. ``output_tokens`` returns ``(pooled,
    tokens)``. ``caches``/``pos`` run one decode step of a single token and
    return ``(tokens, caches)``."""

    def __init__(self, context_length: int = 77, vocab_size: int = 49408,
                 width: int = 512, heads: int = 8, layers: int = 12,
                 mlp_ratio: float = 4.0, ls_init_value: Optional[float] = None,
                 output_dim: int = 512, act: Callable = gelu, attn_impl: str = "auto",
                 compute_dtype: torch.dtype = torch.float32, grad_checkpointing: bool = False,
                 remat_policy: str = "full", embed_cls: bool = False, pad_id: int = 0,
                 output_tokens: bool = False, no_causal_mask: bool = False,
                 pool_type: str = "argmax", proj_type: str = "linear", proj_bias: bool = False,
                 norm_eps: float = 1e-5):
        super().__init__()
        if pool_type not in TEXT_POOL_TYPES:
            raise ValueError(f"text pool_type {pool_type!r}: one of {TEXT_POOL_TYPES}")
        self.context_length = context_length
        self.compute_dtype = compute_dtype
        self.embed_cls, self.pad_id, self.output_tokens = embed_cls, pad_id, output_tokens
        self.causal, self.pool_type = not no_causal_mask, pool_type
        self.token_embedding = nn.Embedding(vocab_size, width)
        self.positional_embedding = nn.Parameter(
            torch.zeros(context_length + (1 if embed_cls else 0), width))
        self.cls_emb = nn.Parameter(torch.zeros(width)) if embed_cls else None
        self.transformer = Transformer(width, layers, heads, mlp_ratio, ls_init_value,
                                       act, attn_impl, grad_checkpointing, remat_policy,
                                       norm_eps)
        self.ln_final = LayerNorm(width, norm_eps)
        if proj_type == "none" or not output_dim:
            self.text_projection = None
        elif proj_bias:
            self.text_projection = nn.Linear(width, output_dim)
        else:
            self.text_projection = nn.Parameter(torch.zeros(width, output_dim))

    def set_grad_checkpointing(self, enable: bool = True) -> None:
        self.transformer.grad_checkpointing = enable

    def _cls_mask(self, text: torch.Tensor) -> torch.Tensor:
        """open_clip's ``build_cls_mask`` (``tpu/models/transformer.py:
        445-462``), quirks kept: only the CLS query row is masked, and its
        column k gates on token k - 1 (column 0 always open). [B, 1, L+1,
        L+1], additive fp32."""
        b, l = text.shape
        ones = torch.ones(b, 1, dtype=torch.bool, device=text.device)
        cls_row = torch.cat([ones, text != self.pad_id], dim=1)
        rows = torch.cat([torch.ones(b, l, l + 1, dtype=torch.bool, device=text.device),
                          cls_row[:, None, :]], dim=1)
        zero = torch.zeros((), device=text.device)
        return torch.where(rows, zero, float("-inf"))[:, None]

    def forward(self, text: torch.Tensor, caches=None, pos: Optional[int] = None):
        if caches is not None:
            # one decode step: the appended CLS sits at the end, causally
            # invisible to the token rows, so this is plain cached attention
            dtype = self.compute_dtype
            x = embed_tokens(self.token_embedding, text).to(dtype)
            x = x + self.positional_embedding[pos:pos + 1].to(dtype)
            x, caches = self.transformer(x, caches=caches, pos=pos)
            return (x if self.embed_cls else self.ln_final(x)), caches
        if not (self.embed_cls or self.output_tokens):
            return encode_text_tokens(self, text)
        dtype = self.compute_dtype
        b, l = text.shape
        x = embed_tokens(self.token_embedding, text).to(dtype)
        mask = None
        if self.embed_cls:
            x = torch.cat([x, self.cls_emb.to(dtype).expand(b, 1, -1)], dim=1)
            l += 1
            if self.causal:  # without the causal rule JAX applies no mask at all
                causal = torch.full((l, l), float("-inf"), device=x.device).triu(1)
                mask = causal + self._cls_mask(text)
        x = x + self.positional_embedding[:l].to(dtype)
        x = self.transformer(x, causal=self.causal and mask is None, mask=mask)
        if self.embed_cls:
            pooled, tokens = self.ln_final(x[:, -1]), x[:, :-1]
        else:
            x = self.ln_final(x)
            pooled, tokens = text_global_pool(x, text, self.pool_type), x
        pooled = project_text(pooled, self.text_projection)
        return (pooled, tokens) if self.output_tokens else pooled


class MultimodalTransformer(nn.Module):
    """CoCa's text decoder (``tpu/models/transformer.py:578-660``): each
    layer a causal self-attention block (``resblocks``), then a
    cross-attention block over the image tokens (``cross_attn``, with
    ``ln_1_kv``), then ``ln_final`` and ``text_projection`` into the
    vocabulary. On CUDA tensors both attentions take the fused kernels
    (``[b, h, L, L]`` causal and ``[b, h, L, T]`` over T image tokens).

    ``compute_cross_kv`` returns each cross block's (k, v) of the image
    tokens; ``cross_caches`` takes them back, and ``caches``/``pos`` run one
    decode step (returns ``(logits, caches)``). Blocks recompute in the
    backward under ``grad_checkpointing`` (training with autograd, no
    caches), as the JAX decoder's ``nn.remat``."""

    def __init__(self, width: int, layers: int, heads: int, context_length: int = 77,
                 mlp_ratio: float = 4.0, ls_init_value: Optional[float] = None,
                 output_dim: int = 512, act: Callable = gelu, attn_impl: str = "auto",
                 grad_checkpointing: bool = False, remat_policy: str = "full",
                 norm_eps: float = 1e-5):
        super().__init__()
        saved_ops(remat_policy)  # raises on an unknown name
        self.context_length = context_length
        self.grad_checkpointing = grad_checkpointing
        self.remat_policy = remat_policy

        def blocks(cross: bool):
            return nn.ModuleList(
                ResidualAttentionBlock(width, heads, mlp_ratio, ls_init_value, act, attn_impl,
                                       norm_eps, is_cross_attention=cross)
                for _ in range(layers))

        self.resblocks, self.cross_attn = blocks(False), blocks(True)
        self.ln_final = LayerNorm(width, norm_eps)
        self.text_projection = nn.Parameter(torch.zeros(width, output_dim))

    def forward(self, image_embs: Optional[torch.Tensor], text_embs: Optional[torch.Tensor],
                caches=None, pos: Optional[int] = None, cross_caches=None,
                compute_cross_kv: bool = False):
        if compute_cross_kv:
            return [blk.cross_kv(image_embs) for blk in self.cross_attn]
        remat = (self.grad_checkpointing and self.training and torch.is_grad_enabled()
                 and caches is None)
        x, new_caches = text_embs, []
        for i, (self_blk, cross_blk) in enumerate(zip(self.resblocks, self.cross_attn)):
            if caches is not None:
                x, cache = self_blk(x, cache=caches[i], pos=pos)
                new_caches.append(cache)
            else:
                x = run_blocks([self_blk], x, remat, self.remat_policy, causal=True)
            if cross_caches is not None:
                x = cross_blk(x, static_kv=cross_caches[i])
            else:
                x = run_blocks([cross_blk], x, remat, self.remat_policy, kv=image_embs)
        x = self.ln_final(x)
        out = x @ self.text_projection.to(x.dtype)
        return (out, new_caches) if caches is not None else out
