"""Tensor parallelism over the mesh's ``model`` axis, in Megatron's dataflow.

The JAX package has no file for this: it gives each parameter a
``PartitionSpec`` (``tpu/parallel/mesh.py:_param_spec``) and GSPMD inserts
the collectives. torch cannot see inside the attention kernels' ctypes
launch, so the port shards by hand. Each rank of a model group holds plain
local ``nn.Parameter`` shards (no DTensors), so the fused kernels see
ordinary contiguous ``[B, H/m, L, d]`` tensors of this rank's heads.

* A column-parallel layer (the packed QKV, ``c_fc``, DINOv2's
  query/key/value, ``fc1`` and the SwiGLU ``weights_in``, EVA02's
  ``fc1_g`` and ``fc1_x``, ViTamin's GeGLU ``w0`` and ``w1``, the DINO
  head's ``fc1``, SigLIP's, Swin's and ViTamin's ``qkv`` and the MAP
  head's ``q`` and packed ``kv``)
  holds its rows of the weight and bias. Its input passes through
  ``copy_to_model``: the identity forward, an all-reduce of the gradient
  in the backward.
* A row-parallel layer (``out_proj``, ``c_proj``, ``output.dense``,
  ``fc2``, ``weights_out``, ViTamin's ``w2``, the timm attention's ``proj``
  and the MAP head's ``proj``)
  holds its columns of the weight and the whole bias. ``row_linear`` multiplies, all-reduces the partial sums
  (``reduce_from_model``: the identity backward) and adds the bias once,
  after the sum.
* The text tower's token embedding is split on its width, as
  ``P(None, MODEL)`` says; the looked-up rows are all-gathered on the last
  dimension (``gather_from_model``: the backward keeps this rank's columns).
* Everything else is whole on every rank: LayerNorms, the class and
  positional embeddings, the patch embedding, the projections, LayerScale,
  the relative-position bias tables, CoCa's attentional pooler (its flax
  leaves match no JAX pattern), Swin's patch merging, and the convolution
  towers (the ModifiedResNet, ConvNeXt and ViTamin's MBConv stages: the JAX
  rule keeps them replicated), so their ranks run the same tower on the
  same rows while the text tower splits as before.
* A whole parameter used on a rank's part (``model_slice``): a relative-
  position table ``[entries, heads]`` feeding this rank's heads (the
  relpos ViT's, Swin's), and the scale and bias of a LayerNorm over a
  width split across the group (``split_layer_norm``: EVA02's sub-LN over
  the merged local heads, its SwiGLU norm over the local hidden). The
  forward takes this rank's contiguous slice in the head order of the
  packed QKV (rank r holds heads ``r H/m ... (r+1) H/m - 1``); the backward
  pads the slice's gradient with zeros to the whole shape and sums it over
  the group, so every rank holds the whole gradient, as a replicated
  parameter must. ``split_layer_norm`` sums each rank's fp32 sum and sum of
  squares over the group (an all-reduce in the forward and in the
  backward: every rank's output depends on every rank's part) and
  normalises its part by the whole width's mean and variance.

So a block runs one all-reduce in the attention and one in the MLP, forward
and backward alike. Every replicated activation and every replicated
parameter's gradient comes out equal on the ranks of a model group.

The packed tensors are split on head boundaries, never as one axis: the
fused ``[3D, D]`` QKV weight as ``[3, H, Dh, D]`` (each rank takes its heads
of q, of k and of v), the SwiGLU ``[2h, D]`` as ``[2, h, D]``. The JAX spec
splits the packed ``[D, 3D]`` kernel on its last axis as a whole, which
GSPMD reshards; here that layout is ``Split(dim, packs)``. Biases of
column-parallel layers are split with their rows, where the JAX rule keeps
every 1-D tensor whole (GSPMD slices it in the matmul): the numbers are the
same.

``param_split(name)`` is the port of ``_param_spec`` on the port's
state-dict names; ``shard_module`` replaces every split parameter of a
whole module by this rank's part and tells the layers their group.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch import nn


@dataclasses.dataclass(frozen=True)
class ModelParallel:
    """A model group: its process group, this rank's index in it, its size."""

    group: object
    rank: int
    world: int


def model_parallel(group) -> Optional[ModelParallel]:
    """The ``ModelParallel`` of ``group``, or None for no group or one rank."""
    if group is None or dist.get_world_size(group) == 1:
        return None
    return ModelParallel(group, dist.get_rank(group), dist.get_world_size(group))


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group``, in place; gloo sums 16-bit floats in fp32."""
    if t.dtype in (torch.bfloat16, torch.float16) and dist.get_backend(group) == "gloo":
        wide = t.float()
        dist.all_reduce(wide, group=group)
        return t.copy_(wide)
    dist.all_reduce(t, group=group)
    return t


class _CopyToModel(torch.autograd.Function):
    """The identity; the backward sums the gradient over the model group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.clone(memory_format=torch.contiguous_format), ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    """The sum over the model group (into a new tensor: the input may be one
    that a remat policy keeps); the backward is the identity."""

    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x.clone(memory_format=torch.contiguous_format), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    """Every rank's last-dimension slice, concatenated in rank order; the
    backward keeps this rank's slice of the gradient. Over gloo a CUDA
    tensor is gathered on the host (as gloo moves it anyway): traced by
    ``torch.export``, the gather becomes one all-gather into a tensor, which
    gloo takes for host tensors only."""

    @staticmethod
    def forward(ctx, x, mp):
        ctx.mp, ctx.n = mp, x.shape[-1]
        device = x.device
        on_host = x.is_cuda and dist.get_backend(mp.group) == "gloo"
        x = x.contiguous().cpu() if on_host else x.contiguous()
        parts = [torch.empty_like(x) for _ in range(mp.world)]
        dist.all_gather(parts, x, group=mp.group)
        whole = torch.cat(parts, dim=-1)
        return whole.to(device) if on_host else whole

    @staticmethod
    def backward(ctx, g):
        return g.narrow(-1, ctx.mp.rank * ctx.n, ctx.n).contiguous(), None


class _SumOverModel(torch.autograd.Function):
    """The sum over the model group of every rank's partial, in both
    directions: each rank uses the sum on its own part alone, so the sum's
    whole gradient is the sum of the ranks' gradients."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x.clone(memory_format=torch.contiguous_format), group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.clone(memory_format=torch.contiguous_format), ctx.group), None


class _ModelSlice(torch.autograd.Function):
    """This rank's contiguous part of a whole tensor along ``dim``; the
    backward pads the part's gradient with zeros to the whole shape and sums
    it over the model group."""

    @staticmethod
    def forward(ctx, t, dim, mp):
        n = t.shape[dim] // mp.world
        ctx.dim, ctx.mp, ctx.shape, ctx.n = dim, mp, t.shape, n
        return t.narrow(dim, mp.rank * n, n).contiguous()

    @staticmethod
    def backward(ctx, g):
        whole = g.new_zeros(ctx.shape)
        whole.narrow(ctx.dim, ctx.mp.rank * ctx.n, ctx.n).copy_(g)
        return _all_reduce(whole, ctx.mp.group), None, None


def model_slice(t: torch.Tensor, dim: int, mp: Optional[ModelParallel]) -> torch.Tensor:
    """This rank's contiguous part of the whole tensor ``t`` along ``dim``
    (``t`` itself without a group); its gradient is the whole one on every
    rank."""
    if mp is None:
        return t
    if t.shape[dim] % mp.world:
        raise ValueError(f"dimension {dim} of {tuple(t.shape)} does not split over {mp.world}")
    return _ModelSlice.apply(t, dim, mp)


def split_layer_norm(x: torch.Tensor, norm: nn.Module, mp: Optional[ModelParallel]
                     ) -> torch.Tensor:
    """``norm`` (a whole ``models/layers.py:LayerNorm``) over a width whose
    part ``x`` holds on this rank (its last dimension, in rank order):
    fp32 statistics of the whole width, this rank's slice of the scale and
    bias, cast back to ``x``'s dtype. Without a group, ``norm(x)``."""
    if mp is None:
        return norm(x)
    x32 = x.float()
    n = x.shape[-1] * mp.world
    sums = _SumOverModel.apply(torch.stack([x32.sum(-1), x32.square().sum(-1)], -1), mp.group)
    mean = sums[..., :1] / n
    var = sums[..., 1:] / n - mean.square()
    y = (x32 - mean) * torch.rsqrt(var + norm.eps)
    y = y * model_slice(norm.weight, 0, mp).float() + model_slice(norm.bias, 0, mp).float()
    return y.to(x.dtype)


def copy_to_model(x: torch.Tensor, mp: Optional[ModelParallel]) -> torch.Tensor:
    return x if mp is None else _CopyToModel.apply(x, mp.group)


def reduce_from_model(x: torch.Tensor, mp: Optional[ModelParallel]) -> torch.Tensor:
    return x if mp is None else _ReduceFromModel.apply(x, mp.group)


def gather_from_model(x: torch.Tensor, mp: Optional[ModelParallel]) -> torch.Tensor:
    return x if mp is None else _GatherFromModel.apply(x, mp)


def column_linear(x: torch.Tensor, layer: nn.Linear, mp: Optional[ModelParallel]
                  ) -> torch.Tensor:
    """``layer`` (this rank's rows) on ``x``, in ``x``'s dtype."""
    return torch.nn.functional.linear(copy_to_model(x, mp), layer.weight.to(x.dtype),
                                      layer.bias.to(x.dtype))


def row_linear(x: torch.Tensor, layer: nn.Linear, mp: Optional[ModelParallel]) -> torch.Tensor:
    """``layer`` (this rank's columns) on ``x``: the partial products summed
    over the model group, then the whole bias added once."""
    w, b = layer.weight.to(x.dtype), layer.bias.to(x.dtype)
    if mp is None:
        return torch.nn.functional.linear(x, w, b)
    return reduce_from_model(torch.nn.functional.linear(x, w), mp) + b


@dataclasses.dataclass(frozen=True)
class Split:
    """How a tensor is split over the model group: on ``dim``, which holds
    ``packs`` tensors stacked (3 for a packed QKV, 2 for a SwiGLU's gate and
    value); each rank takes its contiguous part of every pack."""

    dim: int
    packs: int = 1


# the port's state-dict name endings, with the JAX rule each mirrors
# (``tpu/parallel/mesh.py:_COL_PARALLEL``/``_ROW_PARALLEL``); torch's Linear
# weight is the flax kernel transposed, so P(None, MODEL) splits torch dim 0
# of a weight and P(MODEL, None) dim 1; nn.Embedding keeps flax's layout
_COLUMN = {
    "attn.in_proj_weight": 3, "attn.in_proj_bias": 3,          # attn/in_proj_kernel
    "mlp.c_fc.weight": 1, "mlp.c_fc.bias": 1,                  # mlp/c_fc/kernel
    "attention.attention.query.weight": 1, "attention.attention.query.bias": 1,
    "attention.attention.key.weight": 1, "attention.attention.key.bias": 1,
    "attention.attention.value.weight": 1, "attention.attention.value.bias": 1,
    "mlp.fc1.weight": 1, "mlp.fc1.bias": 1,                    # fc1/kernel
    "mlp.fc1_g.weight": 1, "mlp.fc1_g.bias": 1,                # EVA02's SwiGLU:
    "mlp.fc1_x.weight": 1, "mlp.fc1_x.bias": 1,                # fc1_g/, fc1_x/kernel
    "mlp.weights_in.weight": 2, "mlp.weights_in.bias": 2,      # mlp/weights_in/kernel
    "mlp.w0.weight": 1, "mlp.w0.bias": 1,                      # ViTamin's GeGLU:
    "mlp.w1.weight": 1, "mlp.w1.bias": 1,                      # mlp/w0/, mlp/w1/kernel
    # the timm trunks' attention (SigLIP's, Swin's, ViTamin's: attn/
    # in_proj_kernel) and SigLIP's MAP head, whose one
    # head_attn/in_proj_kernel the exporter splits into q and the packed kv
    "attn.qkv.weight": 3, "attn.qkv.bias": 3,
    "attn_pool.q.weight": 1, "attn_pool.q.bias": 1,
    "attn_pool.kv.weight": 2, "attn_pool.kv.bias": 2,
}
_ROW = ("attn.out_proj.weight", "mlp.c_proj.weight", "attention.output.dense.weight",
        "mlp.fc2.weight", "mlp.weights_out.weight", "mlp.w2.weight",  # ViTamin: mlp/w2
        "attn.proj.weight", "attn_pool.proj.weight")                # timm: attn/out_proj
# CoCa's AttentionalPooler (``models/layers.py``) keeps torch's attention
# names under ``attn_pool.attn.``, which the endings above would match; its
# flax leaves (``attn_pool/{q,k,v,out}_proj``) match no JAX pattern, so it
# stays whole
_WHOLE = "attn_pool.attn."
# the convolution towers stay whole on every rank, as ``tpu/parallel/mesh.py:
# _param_spec`` says of them: ConvNeXt's blocks and head (whose ``mlp.fc1``
# and ``mlp.fc2`` the endings above would match), FastViT's stages (the
# same, and its attention stage's ``token_mixer.qkv``/``proj``; its ``stem``,
# ``final_conv`` and ``head.fc`` match no ending) and the ResNet (whose names
# match none). The JAX spec itself splits FastViT's 4-D 1x1 ``fc1``/``fc2``
# kernels on a dimension of size 1 and cannot place the tower (ROADMAP "Found
# in the JAX package")
_WHOLE_TOWERS = ("visual.trunk.stages.", "visual.head.")
# the DINO head (``losses/dino.py:DinoProjectionHead``, names without a prefix)
_HEAD_COLUMN = {"fc1.weight": 1, "fc1.bias": 1}
_HEAD_ROW = ("fc2.weight",)


def param_split(name: str, head: bool = False) -> Optional[Split]:
    """The split of parameter ``name`` over the model group, or None where it
    stays whole. ``head``: ``name`` is the DINO head's."""
    column, row = (_HEAD_COLUMN, _HEAD_ROW) if head else (_COLUMN, _ROW)
    if not head and (name.startswith(_WHOLE) or "." + _WHOLE in name
                     or name.startswith(_WHOLE_TOWERS)):
        return None
    for end, packs in column.items():
        if name == end or name.endswith("." + end):
            return Split(0, packs)
    for end in row:
        if name == end or name.endswith("." + end):
            return Split(1)
    if not head and (name == "token_embedding.weight" or name.endswith(".token_embedding.weight")):
        return Split(1)
    return None


def split_tensor(whole: torch.Tensor, split: Split, world: int, rank: int) -> torch.Tensor:
    """Rank ``rank``'s part of ``whole`` (a copy)."""
    packs = whole.chunk(split.packs, split.dim)
    return torch.cat([p.chunk(world, split.dim)[rank] for p in packs], split.dim).clone()


def gather_tensor(local: torch.Tensor, split: Split, mp: ModelParallel) -> torch.Tensor:
    """The whole tensor from every rank's part (a collective)."""
    local = local.contiguous()
    parts = [torch.empty_like(local) for _ in range(mp.world)]
    dist.all_gather(parts, local, group=mp.group)
    chunks = [p.chunk(split.packs, split.dim) for p in parts]
    return torch.cat([c[j] for j in range(split.packs) for c in chunks], split.dim)


def whole_shape(shape, split: Optional[Split], world: int):
    """The whole tensor's shape from a part's."""
    if split is None:
        return tuple(shape)
    out = list(shape)
    out[split.dim] *= world
    return tuple(out)


def shard_module(module: nn.Module, mp: Optional[ModelParallel], head: bool = False
                 ) -> Dict[str, Split]:
    """Replaces each parameter that ``param_split`` splits by this rank's part
    (in place, the same ``nn.Parameter`` objects), and gives the group
    (``.tp``) to every layer whose class declares a ``tp`` (the ones that
    run on their rank's part) and to every split embedding. Returns the
    splits by parameter name, also kept as ``module.tp_splits`` (and the
    group as ``module.model_parallel``, which ``parallel/mesh.py:
    full_state_dict`` reads); a module with no group is left whole
    (``{}``). Raises where the group's size does not divide a layer's heads
    or a split dimension."""
    splits = {}
    module.model_parallel = mp
    if mp is None:
        module.tp_splits = splits
        return splits
    for name, m in module.named_modules():
        if hasattr(type(m), "tp"):
            heads = getattr(m, "num_heads", getattr(m, "heads", None))
            if heads is not None and heads % mp.world:
                raise ValueError(f"{name or type(m).__name__}: {heads} heads do not split over "
                                 f"a model axis of {mp.world}")
            m.tp = mp
    with torch.no_grad():
        for name, p in module.named_parameters():
            split = param_split(name, head)
            if split is None:
                continue
            if p.shape[split.dim] % (split.packs * mp.world):
                raise ValueError(f"{name}: dimension {split.dim} of {tuple(p.shape)} does not "
                                 f"split into {split.packs} x {mp.world}")
            p.data = split_tensor(p.data, split, mp.world, mp.rank)
            splits[name] = split
            owner = module.get_submodule(name.rsplit(".", 1)[0]) if "." in name else module
            if isinstance(owner, nn.Embedding):
                owner.tp = mp
    module.tp_splits = splits
    return splits
