"""The device mesh and the placement of parameters and optimizer state.

The port of the JAX package's ``parallel/mesh.py`` on ``torch.distributed``.
One process drives one GPU. ``create_mesh`` builds the ``(data, model)``
mesh with ``init_device_mesh``: rank ``r * model + j`` is model rank ``j``
of data rank ``r``, so the ranks of one model group are neighbours (one
host), as ``_device_array`` keeps the model axis inside one slice. The
data axis carries the batch (``train/distributed.py:data_group``); the
model axis is tensor parallelism (``parallel/tensor.py``: the Megatron
split of the attention and MLP layers, each rank holding plain local
shards, ``param_split`` the port of ``_param_spec``).

Gradients are the data-rank mean: DDP averages them over the data group for
the replicated and the ZeRO-1 routes (``wrap_ddp``), FSDP's reduce-scatter
for ``--fsdp`` (``apply_fsdp``); the model ranks' gradients of replicated
tensors are equal already. One placement rule serves ZeRO-1 and FSDP alike
(``data_shard_dim``, the JAX ``_data_layered_spec``): a tensor of at least
``min_size`` elements (counted whole, as the JAX rule counts them) whose
first dimension the data axis divides is split on that dimension; any
other tensor is replicated over the data axis. It applies to each model
rank's local part, so ZeRO-1 and FSDP split every TP shard over the data
group only. Unlike the JAX rule it also splits at a data axis of 1 (into
one piece), so a one-GPU run goes through the same machinery; and it always
takes dimension 0 of the local part, where the JAX rule takes the axis the
model axis leaves free (torch's ``Linear`` weights are the transpose of the
flax kernels anyway): sharding moves bytes and changes no number.

* ZeRO-1 (``--shard-opt-state``): the parameters stay whole on every data
  rank under DDP; each rank keeps the optimizer state of its slice of every
  split tensor, updates that slice and all-gathers the parameter
  (``ParamSharding``, used by ``train/optim.py:GroupOptimizer``).
* FSDP (``--fsdp``, ZeRO-3, which implies ZeRO-1): ``fully_shard`` over the
  data axis on each residual block of both towers (inside the remat
  wrappers, which call the block), then on the model and on the DINO head.
  Replicated tensors are FSDP's ``ignored_params``; their gradients are
  averaged by ``ParamSharding.average_grads``. ``encode_image`` and
  ``encode_text`` are registered as forward methods, so the evaluations
  unshard too. The live DINOv2 teacher stays unwrapped (TP-split under a
  model axis).
* Whatever the route, ``ParamSharding`` also knows each tensor's model-axis
  split (``tp``, ``tp_splits``): the optimizer sums a split tensor's squares
  and statistics over the model group, and ``full_state_dict`` /
  ``load_full_state_dict`` gather and split the TP shards, so a checkpoint
  holds whole tensors at any ``(data, model)``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
from typing import Callable, Dict, FrozenSet, Iterable, Mapping, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

from .tensor import ModelParallel, Split, gather_tensor, model_parallel, split_tensor, whole_shape

DATA_AXIS = "data"
MODEL_AXIS = "model"

_MESH = None  # the mesh create_mesh built last: the axes' groups


def create_mesh(data: Optional[int] = None, model: int = 1, device_type: Optional[str] = None):
    """The ``(data, model)`` mesh over the process group's ranks; ``data``
    defaults to the world size over ``model``. Every rank calls it."""
    from torch.distributed.device_mesh import init_device_mesh

    global _MESH
    world = dist.get_world_size()
    if model < 1 or world % model:
        raise ValueError(f"--mesh-model-axis {model} does not divide the {world} ranks")
    data = data if data is not None else world // model
    if data * model != world:
        raise ValueError(f"mesh {data}x{model} != {world} ranks")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    _MESH = init_device_mesh(device_type, (data, model), mesh_dim_names=(DATA_AXIS, MODEL_AXIS))
    return _MESH


def axis_group(axis: str):
    """The process group of ``axis`` on this rank, or None where the axis
    holds one rank (or there is no process group). Before ``create_mesh``
    the data axis is every rank and the model axis one."""
    if not dist.is_initialized():
        return None
    if _MESH is None:
        return dist.group.WORLD if axis == DATA_AXIS and dist.get_world_size() > 1 else None
    sub = _MESH[axis]
    return sub.get_group() if sub.size() > 1 else None


def log_mesh(mesh) -> None:
    logging.info("mesh: %s over %d ranks (%s)", dict(zip(mesh.mesh_dim_names, mesh.shape)),
                 mesh.size(), mesh.device_type)


def data_shard_dim(shape: Sequence[int], world: int, min_size: int = 2 ** 16,
                   numel: Optional[int] = None) -> Optional[int]:
    """The dimension a tensor of ``shape`` is split on over ``world`` ranks
    (0), or None where it stays whole: scalars, tensors under ``min_size``
    elements (``numel``, the whole tensor's count where ``shape`` is a
    model rank's part) and first dimensions the world size does not
    divide."""
    if numel is None:
        numel = 1
        for n in shape:
            numel *= n
    if len(shape) < 1 or numel < min_size or shape[0] % world:
        return None
    return 0


@dataclasses.dataclass
class ParamSharding:
    """Which named parameters are split on dimension 0 over the data axis's
    ``group``, and whether they are FSDP's sharded DTensors (``fsdp``) or
    whole tensors that ZeRO-1 slices here; and which are a model rank's
    part (``tp_splits`` over ``tp``, ``parallel/tensor.py``)."""

    group: object
    rank: int
    world: int
    sharded: FrozenSet[str]
    fsdp: bool = False
    tp: Optional[ModelParallel] = None
    tp_splits: Mapping[str, Split] = dataclasses.field(default_factory=dict)

    def tp_split(self, name: str) -> Optional[Split]:
        return self.tp_splits.get(name) if self.tp is not None else None

    def whole_shape(self, name: str, shape) -> tuple:
        """The whole tensor's shape from this model rank's part's."""
        return whole_shape(shape, self.tp_split(name), self.tp.world if self.tp else 1)

    def sum_over(self, t: torch.Tensor, data: bool, model: bool) -> torch.Tensor:
        """``t`` summed, in place, over the data ranks (``data``) and the
        model ranks (``model``) that hold parts of its tensor."""
        if data and self.world > 1:
            dist.all_reduce(t, group=self.group)
        if model and self.tp is not None:
            dist.all_reduce(t, group=self.tp.group)
        return t

    def gather_whole(self, t: torch.Tensor, data: bool, split: Optional[Split]) -> torch.Tensor:
        """The whole tensor from this rank's part: the data slices gathered
        on dimension 0, then the model ranks' parts (a collective)."""
        if data:
            t = self.gather(t)
        if split is not None and self.tp is not None:
            t = gather_tensor(t, split, self.tp)
        return t

    def take_part(self, whole: torch.Tensor, data: bool, split: Optional[Split]) -> torch.Tensor:
        """This rank's part of a whole tensor: the inverse of ``gather_whole``."""
        if split is not None and self.tp is not None:
            whole = split_tensor(whole, split, self.tp.world, self.tp.rank)
        if data:
            whole = whole.chunk(self.world, 0)[self.rank]
        return whole

    def local(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's part of parameter ``name``'s tensor (or gradient): a
        view that an in-place update writes through."""
        if name not in self.sharded:
            return t
        if self.fsdp:
            return t.to_local()
        n = t.shape[0] // self.world
        return t.narrow(0, self.rank * n, n)

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """The whole tensor from every rank's dimension-0 slice."""
        if self.world == 1:
            return local
        out = local.new_empty((local.shape[0] * self.world,) + tuple(local.shape[1:]))
        dist.all_gather_into_tensor(out, local.contiguous(), group=self.group)
        return out

    @torch.no_grad()
    def gather_params(self, params: Mapping[str, torch.Tensor]) -> None:
        """ZeRO-1: every rank's updated slices into each whole parameter."""
        if self.fsdp or self.world == 1:
            return
        for name in sorted(self.sharded):
            p = params[name]
            dist.all_gather_into_tensor(p.data, self.local(name, p.data).clone(),
                                        group=self.group)

    @torch.no_grad()
    def average_grads(self, params: Mapping[str, torch.Tensor]) -> None:
        """FSDP: the rank mean of the replicated (ignored) parameters'
        gradients, which FSDP leaves alone. DDP averages all of them."""
        if not self.fsdp or self.world == 1:
            return
        grads = [p.grad for n, p in params.items()
                 if n not in self.sharded and p.grad is not None]
        if not grads:
            return
        flat = torch.cat([g.reshape(-1).float() for g in grads])
        dist.all_reduce(flat, group=self.group)
        flat /= self.world
        off = 0
        for g in grads:
            g.copy_(flat[off:off + g.numel()].view_as(g))
            off += g.numel()


def _placement(named: Mapping[str, torch.Tensor], group, min_size: Optional[int],
               fsdp: bool, tp: Optional[ModelParallel] = None,
               tp_splits: Optional[Mapping[str, Split]] = None) -> ParamSharding:
    """``data_shard_dim``'s rule over ``group`` (the data axis; None: one
    rank) for the optimizer's named parameters (model ranks' parts where
    ``tp_splits`` names them); ``min_size`` None splits nothing."""
    rank, world = (dist.get_rank(group), dist.get_world_size(group)) if group else (0, 1)
    tp_splits = dict(tp_splits or {}) if tp is not None else {}
    m = tp.world if tp is not None else 1
    sharded = frozenset() if min_size is None else frozenset(
        n for n, p in named.items()
        if data_shard_dim(p.shape, world, min_size,
                          p.numel() * (m if n in tp_splits else 1)) is not None)
    return ParamSharding(group, rank, world, sharded, fsdp, tp, tp_splits)


def zero1_sharding(named: Mapping[str, torch.Tensor], group, min_size: int = 2 ** 16,
                   tp: Optional[ModelParallel] = None,
                   tp_splits: Optional[Mapping[str, Split]] = None) -> ParamSharding:
    """ZeRO-1's placement of whole parameters over ``group``; ``named`` are
    the optimizer's (``train/step.py:train_parameters``), ``tp_splits``
    theirs under a model axis ``tp`` (``train/step.py:train_splits``)."""
    return _placement(named, group, min_size, False, tp, tp_splits)


def tp_sharding(named: Mapping[str, torch.Tensor], group, tp: Optional[ModelParallel],
                tp_splits: Mapping[str, Split]) -> ParamSharding:
    """The placement of a run with replicated optimizer state under a model
    axis: nothing split over the data axis, the model ranks' parts known."""
    return _placement(named, group, None, False, tp, tp_splits)


def _blocks(model: nn.Module) -> Iterable[nn.Module]:
    """The residual blocks of every tower (CoCa's text tower and decoder
    included)."""
    for tower in (getattr(model, "visual", None), model, getattr(model, "text", None)):
        transformer = getattr(tower, "transformer", None)
        yield from getattr(transformer, "resblocks", ())
    decoder = getattr(model, "text_decoder", None)
    for kind in ("resblocks", "cross_attn"):
        yield from getattr(decoder, kind, ())


def apply_fsdp(model: nn.Module, head: Optional[nn.Module], mesh,
               named: Mapping[str, nn.Parameter], min_size: int = 2 ** 16) -> ParamSharding:
    """``fully_shard`` over ``mesh``'s data axis: each residual block, then
    the model and the head (two roots). ``named`` are the optimizer's names
    of every parameter of both (``train/step.py:train_parameters``), and
    the placement returned is by those names. FSDP replaces the parameters
    with its DTensors: the optimizer takes them from ``train_parameters``
    afterwards."""
    from torch.distributed.fsdp import fully_shard, register_fsdp_forward_method

    from ..train.optim import HEAD_PREFIX

    dmesh = mesh[DATA_AXIS]
    group = dmesh.get_group()
    tp = model_parallel(axis_group(MODEL_AXIS))
    tp_splits = dict(getattr(model, "tp_splits", {}))
    tp_splits.update({HEAD_PREFIX + k: v for k, v in getattr(head, "tp_splits", {}).items()})
    if dmesh.device_type == "cuda" and dist.get_backend(group) == "gloo":
        # fully_shard's collectives over gloo on CUDA tensors end the process
        # (torch 2.11 on the H100: chip_smoke.py's gloo probe)
        raise RuntimeError("FSDP over gloo with CUDA tensors crashes: use NCCL (one GPU a rank)")
    own = list(model.parameters()) + (list(head.parameters()) if head is not None else [])
    if {id(p) for p in own} != {id(p) for p in named.values()}:
        raise ValueError("named must hold every parameter of the model and the head")
    sharding = _placement(named, group, min_size, True, tp, tp_splits)
    ignored = {p for n, p in named.items() if n not in sharding.sharded}
    for blk in _blocks(model):
        fully_shard(blk, mesh=dmesh, ignored_params=ignored)
    fully_shard(model, mesh=dmesh, ignored_params=ignored)
    for method in ("encode_image", "encode_text"):
        register_fsdp_forward_method(model, method)
    if head is not None:
        fully_shard(head, mesh=dmesh, ignored_params=ignored)
    return sharding


def wrap_ddp(module: nn.Module, device: torch.device, group=None, static_graph: bool = False):
    """DDP over ``group``: gradients averaged over the ranks in the
    backward; buffers are not broadcast (every rank builds the same)."""
    from torch.nn.parallel import DistributedDataParallel

    device_ids = None
    if device.type == "cuda":
        device_ids = [device.index if device.index is not None else torch.cuda.current_device()]
    return DistributedDataParallel(module, device_ids=device_ids, process_group=group,
                                   broadcast_buffers=False, static_graph=static_graph)


@contextlib.contextmanager
def grad_sync_paused(module: nn.Module):
    """No gradient reduction in the backward inside: DDP's ``no_sync``, or
    every FSDP module's ``set_requires_gradient_sync(False)``; a plain
    module is left as it is."""
    from torch.distributed.fsdp import FSDPModule
    from torch.nn.parallel import DistributedDataParallel

    if isinstance(module, DistributedDataParallel):
        with module.no_sync():
            yield
        return
    fsdp = [m for m in module.modules() if isinstance(m, FSDPModule)]
    for m in fsdp:
        m.set_requires_gradient_sync(False, recurse=False)
    try:
        yield
    finally:
        for m in fsdp:
            m.set_requires_gradient_sync(True, recurse=False)


def is_writer() -> bool:
    """Rank 0, or the one process: the rank that writes files."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _tp_of(module: nn.Module):
    """The model group and the splits of a TP-split module (``shard_module``)."""
    return getattr(module, "model_parallel", None), getattr(module, "tp_splits", {})


def full_state_dict(module: nn.Module, cpu_offload: bool = False) -> Dict[str, torch.Tensor]:
    """``module.state_dict()`` with every sharded DTensor gathered whole and
    every model rank's part gathered with the others' (collectives under
    FSDP or a model axis: every rank calls it). ``cpu_offload``: each
    tensor is gathered in turn and copied to host memory by the writer
    alone (``is_writer``), the others get ``{}``; no device then holds
    more than one whole tensor beyond its shards."""
    from torch.distributed.tensor import DTensor

    keep = not cpu_offload or is_writer()
    mp, splits = _tp_of(module)
    out = {}
    for k, v in module.state_dict().items():
        whole = (v.full_tensor() if isinstance(v, DTensor) else v).detach()
        if mp is not None and k in splits:
            whole = gather_tensor(whole, splits[k], mp)
        if keep:
            out[k] = whole.to("cpu", copy=True) if cpu_offload else whole
        del whole  # freed before the next gather
    return out


@torch.no_grad()
def load_full_state_dict(module: nn.Module, state: Mapping[str, torch.Tensor],
                         strict: bool = True) -> None:
    """Loads whole tensors into ``module``: a model rank's part of each
    TP-split tensor first, then into each sharded DTensor its data rank's
    dimension-0 slice, into the others the tensor itself; a module without
    DTensors takes ``load_state_dict``."""
    from torch.distributed.tensor import DTensor

    mp, splits = _tp_of(module)
    if mp is not None:
        state = {k: split_tensor(v, splits[k], mp.world, mp.rank) if k in splits else v
                 for k, v in state.items()}
    own = module.state_dict()
    if not any(isinstance(t, DTensor) for t in own.values()):
        module.load_state_dict(state, strict=strict)
        return
    if strict and set(own) != set(state):
        missing, unexpected = sorted(set(own) - set(state)), sorted(set(state) - set(own))
        raise RuntimeError(f"state dict mismatch: missing {missing}, unexpected {unexpected}")
    for k, t in own.items():
        if k not in state:
            continue
        src = state[k]
        if tuple(src.shape) != tuple(t.shape):
            raise RuntimeError(f"{k}: saved {tuple(src.shape)}, expected {tuple(t.shape)}")
        if isinstance(t, DTensor):
            mesh = t.device_mesh
            t.to_local().copy_(src.chunk(mesh.size(), 0)[mesh.get_local_rank()])
        else:
            t.copy_(src)


def on_rank_rows(fn: Callable, *tensors: torch.Tensor, group=None):
    """``fn`` over a batch that every rank holds whole, each rank computing
    its share: the rows padded to a multiple of the world size by repeating
    the last one, this rank's contiguous share through ``fn`` (every rank
    calls it, as FSDP's forward needs), every share all-gathered and the
    padding rows dropped. ``fn`` returns a tensor or a tuple of tensors with
    one row per input row. One process: ``fn(*tensors)``."""
    world = dist.get_world_size(group) if group is not None else 1
    if world == 1:
        return fn(*tensors)
    rank = dist.get_rank(group)
    b = tensors[0].shape[0]
    pad = (-b) % world
    if pad:
        tensors = tuple(torch.cat([t, t[-1:].expand(pad, *t.shape[1:])]) for t in tensors)
    per = (b + pad) // world
    outs = fn(*(t.narrow(0, rank * per, per) for t in tensors))
    single = isinstance(outs, torch.Tensor)
    full = []
    for o in ((outs,) if single else outs):
        parts = [torch.empty_like(o) for _ in range(world)]
        dist.all_gather(parts, o.contiguous(), group=group)
        full.append(torch.cat(parts)[:b])
    return full[0] if single else tuple(full)
