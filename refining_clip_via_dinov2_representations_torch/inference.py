"""Serving engine: bucketed batching over the two towers, weight-only int8,
and a model split over ``torch.distributed`` ranks.

The port of the JAX package's ``inference.py`` ``ClipInferenceEngine``.
Requests are padded up to a small ladder of batch buckets, so the device
sees a few fixed shapes; larger requests are chunked by the top bucket.
``warmup`` runs every (tower, bucket) once, which on the card also builds
the CUDA kernels before the first request.

Precision follows the JAX engine: images are rounded to the engine dtype
(bf16 by default) on the device, then the model casts them to its compute
dtype (fp32 under the default precision); features are L2-normalised in
fp32 (a CoCa engine's are its normalised latents). ``caption_tokens``
captions images with a CoCa model's grouped beam search
(``models/coca.py:generate_beam``), bucketed like the encoders.

* ``quantize="int8"`` (``tpu/inference.py:51-122``): every floating
  parameter of at least 2 dimensions and ``quantize_min_size`` elements
  (counted on its JAX leaf) but the token and positional tables is kept on
  the device as int8 with a per-output-channel fp32 scale, and is
  dequantized to fp32 at each use (a convolution's OIHW weight per output
  channel, dimension 0, as the JAX engine scales its HWIO kernel's last
  axis; BatchNorm's running statistics are buffers and stay fp32; a
  ``torch.nn.utils.parametrize``
  parametrization on the attribute), as the JAX engine dequantizes inside
  its jitted call. The products stay ``F.linear``/``torch.matmul`` on the
  dequantized weights: the JAX package forms them in XLA, not in a kernel.
* ``mesh``, a ``(data, model)`` mesh of ``parallel/mesh.py:create_mesh``:
  every rank builds the engine on the same whole model, which it splits
  over its model group (``parallel/tensor.py:shard_module``); buckets round
  up to multiples of the data axis's size. Rank 0 drives: each call sends
  the operation and the padded batch to every rank over a gloo group of
  its own, each data group runs its contiguous share of the rows (the
  ranks of a model group run the same rows together), and rank 0 gathers
  the results. The other ranks wait in ``follow`` until ``stop``. This is
  the JAX engine's one controller on one host, with one process a card.
  ``mesh`` with int8 keeps the int8 weights whole on every rank and logs
  the JAX engine's warning.

The deployable artifact (``tpu/inference.py:419-682``): ``export`` writes
one ``torch.export`` program per (encoder, bucket), ``encode_image_b{B}.pt2``
and ``encode_text_b{B}.pt2``, each what ``_compute`` runs for that encoder
at static shapes: NHWC float32 images rounded to the engine dtype, or int32
ids widened to int64, then the tower, then the fp32 L2 norm (the JAX
artifact's input layout, so one array feeds either). The attention kernels
are ``torch.library`` custom ops (``rcd_torch::``), so the graph calls them
and a reloaded program launches them. Each file records the device it was
traced on and the engine's TF32 flags, which the loaders set.

* One process: the weights the encoder reads are baked into its program as
  constants, as the JAX ``_bake`` bakes them (each bucket's file repeats its
  tower's weights; an int8 engine's hold the int8 values and fp32 scales,
  dequantized in the graph). ``load_exported(path)`` returns a callable from
  a batch to its features, on the traced device.
* A mesh: each program is the rank-local one, this rank's parameters taken
  as call arguments (``torch.func.functional_call``) and the model axis's
  collectives traced as ``_c10d_functional`` ops; it holds no weights.
  ``params.npz`` holds every tensor once, whole (bf16 as its uint16 bits),
  and ``sharding_manifest.json`` the mesh's axes, the batch layout, each
  tensor's name, ``Split`` (null when whole) and dtype, and an
  ``export_id``. ``load_exported_sharded(out_dir, name, mesh)`` places this
  rank's parts once per (directory, freshness, mesh), binds the graph's
  collectives to the mesh's model group, and returns a callable that every
  rank calls with the same full batch.

The loaders need torch and this package's ``ops`` (which registers the ops),
no model code.
"""

from __future__ import annotations

import dataclasses
import datetime
import io
import json
import logging
import os
import threading
import uuid
from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

DEFAULT_BUCKETS = (1, 8, 32, 128)
_CAPTION_MAX_BEAMS = 16  # the JAX engine's cap on a request's beam width

# -------------------------------------------------------------- weight-only int8

_QUANT_MIN_SIZE = 1 << 14  # the JAX engine's: tensors under 16k elements stay as they are
# the port's names of the leaves that the JAX ``_QUANT_SKIP_KEYS`` skip (token
# and positional tables) in the families it builds; SigLIP's ``pos_embed``
# is the JAX leaf ``position_embedding``, which no skip key names, so it is
# quantized there and here
_QUANT_SKIP_ENDINGS = ("token_embedding.weight", "positional_embedding")
# tensors that the exporter assembles from JAX leaves of another size: the
# size rule counts the leaf's elements (numerator, denominator)
_QUANT_LEAF_SIZE = {"attn_pool.q.weight": (3, 1),                # head_attn/in_proj_kernel
                    "attn_pool.kv.weight": (3, 2),
                    "attn_pool.attn.in_proj_weight": (1, 3)}     # CoCa's {q,k,v}_proj


@dataclasses.dataclass
class Int8Weight:
    """A quantized tensor: int8 values and the fp32 scale of each output
    channel, shaped to broadcast against them."""

    q: torch.Tensor
    scale: torch.Tensor

    def dequantize(self, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        return self.q.to(dtype) * self.scale.to(dtype)


def _channel_dim(name: str, t: torch.Tensor) -> int:
    """The dimension of ``t`` that holds the flax kernel's last axis: 0 for
    torch's Linear, convolution and packed projection weights (the kernel
    transposed), the last for a matrix the port applies as ``x @ P``
    (``visual.proj``, ``text_projection``, the pooler's ``query``) and for
    the position tables, which keep the flax layout."""
    return 0 if name.endswith("weight") else t.dim() - 1


def _leaf_numel(name: str, t: torch.Tensor) -> int:
    for end, (num, den) in _QUANT_LEAF_SIZE.items():
        if name == end or name.endswith("." + end):
            return t.numel() * num // den
    return t.numel()


def quantize_tensor_int8(w: torch.Tensor, dim: int) -> Int8Weight:
    """``tpu/inference.py:_quantize_leaf`` on ``dim``'s channels: the scale
    ``max(amax, 1e-12) / 127`` over every other dimension, the values
    ``clip(round(w / scale), -127, 127)`` (round half to even, as
    ``jnp.round``)."""
    w = w.detach().float()
    others = [d for d in range(w.dim()) if d != dim]
    amax = w.abs().amax(dim=others, keepdim=True)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return Int8Weight(q, scale)


def _skipped(names) -> set:
    """The names among ``names`` whose JAX leaf ``_QUANT_SKIP_ENDINGS`` skips
    under another name: a ViTamin or MCi trunk's ``pos_embed`` is the JAX
    ``positional_embedding``, where SigLIP's is ``position_embedding``
    (quantized), ``models/convert.py:jax_positional_names``."""
    from .models.convert import jax_positional_names

    return jax_positional_names(names)


def quantizes(name: str, t: torch.Tensor, min_size: int = _QUANT_MIN_SIZE,
              skip=frozenset()) -> bool:
    """Whether ``quantize_state_dict_int8`` stores tensor ``name`` as int8:
    the JAX ``quantize_variables_int8`` rule on the port's names (``skip``:
    the model's ``_skipped`` names)."""
    if name.endswith(_QUANT_SKIP_ENDINGS) or name in skip:
        return False
    return t.dim() >= 2 and t.is_floating_point() and _leaf_numel(name, t) >= min_size


def quantize_state_dict_int8(state_dict: Mapping[str, torch.Tensor],
                             min_size: int = _QUANT_MIN_SIZE
                             ) -> Dict[str, Union[torch.Tensor, Int8Weight]]:
    """Each tensor that ``quantizes`` names as an ``Int8Weight``, the others
    as they are: the port of ``quantize_variables_int8`` on an open_clip
    state dict."""
    skip = _skipped(state_dict)
    return {k: quantize_tensor_int8(v, _channel_dim(k, v)) if quantizes(k, v, min_size, skip)
            else v for k, v in state_dict.items()}


def dequantize(state_dict: Mapping[str, Union[torch.Tensor, Int8Weight]],
               dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """The inverse of ``quantize_state_dict_int8`` (``dequantize_variables``):
    ``q * scale`` in ``dtype``."""
    return {k: v.dequantize(dtype) if isinstance(v, Int8Weight) else v
            for k, v in state_dict.items()}


class _Dequantize(nn.Module):
    """The parametrization of a quantized attribute: the stored int8 values
    times the channels' scale, in fp32, at each read."""

    def __init__(self, scale: torch.Tensor):
        super().__init__()
        self.register_buffer("scale", scale)

    def forward(self, q: torch.Tensor) -> torch.Tensor:
        return q.to(self.scale.dtype) * self.scale


def quantize_module_int8(model: nn.Module, min_size: int = _QUANT_MIN_SIZE) -> None:
    """Replaces every parameter that ``quantizes`` names by its int8 values
    (on its device) under a ``_Dequantize`` parametrization."""
    from torch.nn.utils import parametrize

    params = list(model.named_parameters())
    skip = _skipped(n for n, _ in params)
    for name, p in params:
        if not quantizes(name, p, min_size, skip):
            continue
        qw = quantize_tensor_int8(p, _channel_dim(name, p))
        owner_name, _, attr = name.rpartition(".")
        owner = model.get_submodule(owner_name)
        setattr(owner, attr, nn.Parameter(qw.q, requires_grad=False))
        parametrize.register_parametrization(owner, attr, _Dequantize(qw.scale), unsafe=True)


def resident_bytes(model: nn.Module) -> Dict[str, int]:
    """The bytes the model keeps on its device: ``int8`` (the quantized
    values), ``total`` (every parameter and buffer, the scales included)."""
    tensors = list(model.parameters()) + list(model.buffers())
    return {"int8": sum(t.numel() for t in tensors if t.dtype == torch.int8),
            "total": sum(t.numel() * t.element_size() for t in tensors)}


# ------------------------------------------------------------------ the engine

_ENCODERS = ("encode_image", "encode_text")


class _Encoder(nn.Module):
    """One encoder as the engine runs it: images (NHWC float32) rounded to
    ``dtype``, or int32 ids widened, through the tower, L2-normalised in
    fp32 (a CoCa model's latents)."""

    def __init__(self, model: nn.Module, op: str, dtype: torch.dtype):
        super().__init__()
        self.model, self.op, self.dtype = model, op, dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.op == "encode_image":
            feats = self.model.encode_image(x.to(self.dtype), normalize=False).float()
        else:
            feats = self.model.encode_text(x.long(), normalize=False).float()
        return feats / feats.norm(dim=-1, keepdim=True)


def _bucket_for(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


class ClipInferenceEngine:
    """Bucketed two-tower encoder.

    Args:
      model: a built ``models.clip.CLIP`` (or CoCa) on its serving device;
        whole on every rank under a ``mesh``.
      image_size: (H, W) expected by the vision tower.
      context_length: text sequence length (77 for CLIP BPE).
      buckets: ascending batch-size ladder.
      dtype: the dtype images are rounded to before the vision tower.
      quantize: None or ``"int8"`` (weight-only, see the module docstring).
      quantize_min_size: the int8 rule's least tensor size.
      mesh: a ``(data, model)`` mesh (``parallel/mesh.py:create_mesh``) over
        the process group, or None for one process.
    """

    def __init__(self, model, image_size: Tuple[int, int] = (224, 224),
                 context_length: int = 77, buckets: Sequence[int] = DEFAULT_BUCKETS,
                 dtype: torch.dtype = torch.bfloat16, quantize: Optional[str] = None,
                 quantize_min_size: int = _QUANT_MIN_SIZE, mesh=None):
        if quantize not in (None, "int8"):
            raise ValueError(f"unknown quantize mode {quantize!r}")
        self.model = model.eval()
        self.device = model.logit_scale.device
        self.image_size = tuple(image_size)
        self.context_length = int(context_length)
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        self.dtype = dtype
        self._encoders = {op: _Encoder(self.model, op, dtype) for op in _ENCODERS}
        self.quantize = quantize
        self.mesh = mesh
        self.leader = True
        self.broken = threading.Event()  # a mesh call failed: the ranks are out of step
        if mesh is not None:
            self._join(mesh, quantize is not None)
        if quantize == "int8":
            quantize_module_int8(model, quantize_min_size)
        if self.device.type == "cuda" and model.compute_dtype == torch.float32:
            # fp32 serving stays fp32: TF32 keeps ~3 decimal digits
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False

    def _join(self, mesh, replicate: bool) -> None:
        """This rank's part of the mesh: its model group's split, its data
        group's rows, the control group."""
        import torch.distributed as dist

        from .parallel.mesh import DATA_AXIS, MODEL_AXIS
        from .parallel.tensor import model_parallel, shard_module

        self._ndata = mesh[DATA_AXIS].size()
        self._model_world = mesh[MODEL_AXIS].size()
        self._data_rank = mesh[DATA_AXIS].get_local_rank()
        if self._ndata > 1:
            self.buckets = tuple(sorted(set(max(self._ndata, -(-b // self._ndata) * self._ndata)
                                            for b in self.buckets)))
        if replicate:
            logging.warning(
                "mesh + quantize='int8': int8 weights are replicated on every device (no TP "
                "sharding); if the quantized checkpoint doesn't fit one chip, drop quantize "
                "and use the TP-sharded path instead")
        else:
            shard_module(self.model, model_parallel(mesh[MODEL_AXIS].get_group()))
        # requests arrive at any time: the control group waits without a deadline
        self._control = dist.new_group(backend="gloo", timeout=datetime.timedelta(days=365))
        self.leader = dist.get_rank() == 0
        self._lock = threading.Lock()

    # -- one call ----------------------------------------------------------------

    def _compute(self, op: str, x: np.ndarray, gen: dict) -> np.ndarray:
        """``op`` on this process's rows (numpy in, numpy out)."""
        with torch.inference_mode():
            t = torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
            if op in _ENCODERS:
                return self._encoders[op](t).cpu().numpy()
            from torch.nn.utils import parametrize

            from .models.coca import generate_beam

            # int8: each weight dequantized once a call, not once a decode step
            with parametrize.cached():
                return generate_beam(self.model, t.to(self.dtype), **gen).int().cpu().numpy()

    def _send(self, op: str, x: Optional[np.ndarray] = None, gen: Optional[dict] = None):
        """Rank 0: the operation (and its batch) to every rank."""
        import torch.distributed as dist

        header = [op, None if x is None else (tuple(x.shape), x.dtype.str), gen or {}]
        dist.broadcast_object_list(header, src=0, group=self._control)
        if x is not None:
            dist.broadcast(torch.from_numpy(np.ascontiguousarray(x)), src=0, group=self._control)

    def _receive(self):
        """A follower: the next operation and its batch from rank 0."""
        import torch.distributed as dist

        header = [None, None, None]
        dist.broadcast_object_list(header, src=0, group=self._control)
        op, spec, gen = header
        if spec is None:
            return op, None, gen
        t = torch.from_numpy(np.empty(spec[0], np.dtype(spec[1])))
        dist.broadcast(t, src=0, group=self._control)
        return op, t.numpy(), gen

    def _rows(self, op: str, x: np.ndarray, gen: dict) -> Optional[np.ndarray]:
        """Every rank: its data group's share of the padded batch through
        ``op``; rank 0 returns the shares gathered in order (model rank 0 of
        each data group), the others None."""
        import torch.distributed as dist

        per = x.shape[0] // self._ndata
        out = torch.from_numpy(np.ascontiguousarray(
            self._compute(op, x[self._data_rank * per:(self._data_rank + 1) * per], gen)))
        parts = [torch.empty_like(out) for _ in range(dist.get_world_size())] \
            if self.leader else None
        dist.gather(out, parts, dst=0, group=self._control)
        if not self.leader:
            return None
        return torch.cat([parts[r * self._model_world] for r in range(self._ndata)]).numpy()

    def _call(self, op: str, x: np.ndarray, gen: Optional[dict] = None) -> np.ndarray:
        """``op`` on one padded batch: here, or over every rank of the mesh."""
        gen = gen or {}
        if self.mesh is None:
            return self._compute(op, x, gen)
        if not self.leader:
            raise RuntimeError("a follower rank takes its calls from rank 0: run follow()")
        with self._lock:
            if self.broken.is_set():
                raise RuntimeError("an earlier call failed on the mesh; the ranks are out of step")
            try:
                self._send(op, x, gen)
                return self._rows(op, x, gen)
            except Exception:
                self.broken.set()
                raise

    def follow(self) -> None:
        """A follower rank's loop: each operation rank 0 sends, on this
        rank's rows, until ``stop``. Raises where a call fails (the process
        should then end: the other ranks are out of step)."""
        if self.mesh is None or self.leader:
            raise RuntimeError("follow() runs on the follower ranks of a mesh")
        while True:
            op, x, gen = self._receive()
            if op == "stop":
                return
            self._rows(op, x, gen)

    def stop(self) -> None:
        """Rank 0: ends every follower's ``follow`` (a no-op without a mesh)."""
        if self.mesh is not None and self.leader and not self.broken.is_set():
            with self._lock:
                self._send("stop")

    def _run_bucketed(self, op: str, x: np.ndarray, gen: Optional[dict] = None) -> np.ndarray:
        """Pad to the bucket, run, slice back; chunk past the top bucket."""
        n, top = x.shape[0], self.buckets[-1]
        if n > top:
            return np.concatenate([self._run_bucketed(op, x[i:i + top], gen)
                                   for i in range(0, n, top)], axis=0)
        b = _bucket_for(n, self.buckets)
        if b != n:
            x = np.concatenate([x, np.zeros((b - n, *x.shape[1:]), x.dtype)], axis=0)
        return self._call(op, x, gen)[:n]

    # -- public API --------------------------------------------------------------

    def encode_image(self, images: np.ndarray) -> np.ndarray:
        """[N,H,W,3] float (0-mean preprocessed) -> [N,D] unit vectors."""
        return self._run_bucketed("encode_image", np.asarray(images, np.float32))

    def encode_text(self, texts: np.ndarray) -> np.ndarray:
        """[N,L] int32 token ids -> [N,D] unit vectors."""
        return self._run_bucketed("encode_text", np.asarray(texts, np.int32))

    def caption_tokens(self, images: np.ndarray, seq_len: int = 30, num_beams: int = 6,
                       num_beam_groups: int = 3, min_seq_len: int = 5,
                       repetition_penalty: float = 1.0, length_penalty: float = 1.0,
                       sot_token_id: int = 49406, eot_token_id: int = 49407,
                       pad_token_id: int = 0) -> np.ndarray:
        """Caption a preprocessed image batch with the grouped beam search
        (CoCa models only; the JAX engine's defaults): [N,H,W,3] floats ->
        [N, seq_len] int32 ids (SOT ... EOT, pad-filled), bucketed and padded
        like the encoders; the int8 and mesh routes apply unchanged (every
        rank of a model group chooses the same tokens: its logits are
        all-reduced). On the card the image tower runs the fused kernel (one
        launch a layer); the decode steps take plain attention, as in the
        JAX package."""
        from .models.coca import CoCa

        if not isinstance(self.model, CoCa):
            raise TypeError(
                f"caption_tokens requires a CoCa model (got {type(self.model).__name__})")
        if not 1 < num_beams <= _CAPTION_MAX_BEAMS:
            raise ValueError(f"num_beams must be in [2, {_CAPTION_MAX_BEAMS}], got {num_beams}")
        gen = dict(num_beams=num_beams, num_beam_groups=num_beam_groups, seq_len=seq_len,
                   sot_token_id=sot_token_id, eot_token_id=eot_token_id,
                   pad_token_id=pad_token_id, min_seq_len=min_seq_len,
                   repetition_penalty=repetition_penalty, length_penalty=length_penalty)
        return self._run_bucketed("caption", np.asarray(images, np.float32), gen)

    def logit_terms(self) -> Tuple[float, float]:
        """(exp(logit_scale), logit_bias-or-0): the affine on feature cosines."""
        scale = float(self.model.logit_scale.detach().float().exp())
        bias = self.model.logit_bias
        return scale, 0.0 if bias is None else float(bias.detach())

    def similarity(self, images: np.ndarray, texts: np.ndarray) -> np.ndarray:
        """Scaled image->text logits."""
        img_f = self.encode_image(images)
        txt_f = self.encode_text(texts)
        scale, bias = self.logit_terms()
        return scale * img_f @ txt_f.T + bias

    def warmup(self) -> None:
        """Run one zero batch per (tower, bucket); under a mesh rank 0's
        warmup runs every rank's (a follower's is a no-op)."""
        if not self.leader:
            return
        h, w = self.image_size
        for b in self.buckets:
            self.encode_image(np.zeros((b, h, w, 3), np.float32))
            self.encode_text(np.zeros((b, self.context_length), np.int32))

    # -- deployable artifact -----------------------------------------------------

    def export(self, out_dir: str) -> Dict[str, str]:
        """One ``torch.export`` program per (encoder, bucket) in ``out_dir``:
        ``encode_image_b{B}.pt2`` and ``encode_text_b{B}.pt2`` (the module
        docstring says what each holds). One process bakes the weights in;
        under a mesh every rank calls this (it gathers the weights), rank 0
        writes the programs, ``params.npz`` and ``sharding_manifest.json``,
        and ``out_dir`` must be on a filesystem every rank sees. Returns
        {name: path}."""
        if self.mesh is not None:
            return self._export_sharded(out_dir)
        os.makedirs(out_dir, exist_ok=True)
        written = {}
        for b in self.buckets:
            for op in _ENCODERS:
                program = _trace(_Baked(self._encoders[op]), (self._example(op, b),))
                written[f"{op}_b{b}"] = path = os.path.join(out_dir, f"{op}_b{b}.pt2")
                torch.export.save(program, path, extra_files=_program_meta(self.device))
        return written

    def _example(self, op: str, rows: int) -> torch.Tensor:
        """A zero batch of ``rows`` in the artifact's input layout."""
        if op == "encode_image":
            return torch.zeros(rows, *self.image_size, 3, device=self.device)
        return torch.zeros(rows, self.context_length, dtype=torch.int32, device=self.device)

    def _export_sharded(self, out_dir: str) -> Dict[str, str]:
        """``export`` under a mesh: each rank's program takes its parameters
        as the call's first argument and its data group's rows; every tensor
        is gathered whole and every program serialised before a file is
        written, so an error leaves no half-written directory."""
        import torch.distributed as dist

        from .parallel.mesh import DATA_AXIS, MODEL_AXIS
        from .parallel.tensor import gather_tensor, model_parallel

        tensors = dict(self.model.named_parameters())
        tensors.update(self.model.named_buffers())
        names = tuple(tensors)
        local = tuple(t.detach() for t in tensors.values())
        blobs, written = {}, {}
        for b in self.buckets:
            for op in _ENCODERS:
                program = _trace(_WeightsAsInputs(self._encoders[op], names),
                                 (local, self._example(op, b // self._ndata)))
                buf = io.BytesIO()
                torch.export.save(program, buf, extra_files=_program_meta(self.device))
                blobs[f"{op}_b{b}"] = buf.getvalue()
                written[f"{op}_b{b}"] = os.path.join(out_dir, f"{op}_b{b}.pt2")
        group = self.mesh[MODEL_AXIS].get_group()
        mp = model_parallel(group)
        splits = getattr(self.model, "tp_splits", {})
        arrays, entries = {}, []
        for i, (name, t) in enumerate(zip(names, local)):
            split = splits.get(name)
            whole = (t if split is None else gather_tensor(t, split, mp)).cpu()
            # npy has no bfloat16: its bit pattern, as tpu/inference.py stores it
            arrays[f"param_{i:05d}"] = (whole.view(torch.int16).numpy().view(np.uint16)
                                        if whole.dtype == torch.bfloat16 else whole.numpy())
            entries.append({"name": name, "dtype": str(whole.dtype).split(".")[-1],
                            "split": None if split is None else dataclasses.asdict(split)})
        manifest = {
            "mesh_axes": {DATA_AXIS: self._ndata, MODEL_AXIS: self._model_world},
            # each data rank runs its contiguous share of the rows
            "batch_spec": [DATA_AXIS],
            "params": entries,
            # the graphs' collectives name this group; the loader rebinds them
            "model_group": group.group_name,
            # unique per export: the params cache keys on it
            "export_id": uuid.uuid4().hex,
        }
        written["params"] = os.path.join(out_dir, "params.npz")
        written["manifest"] = os.path.join(out_dir, "sharding_manifest.json")
        if dist.get_rank() == 0:
            os.makedirs(out_dir, exist_ok=True)
            for key, blob in blobs.items():
                with open(written[key], "wb") as f:
                    f.write(blob)
            np.savez(written["params"], **arrays)
            with open(written["manifest"], "w") as f:
                json.dump(manifest, f)
        dist.barrier(group=self._control)
        missing = [p for p in written.values() if not os.path.exists(p)]
        if missing:
            raise FileNotFoundError(
                f"export(out_dir={out_dir!r}): rank {dist.get_rank()} cannot see "
                f"{[os.path.basename(m) for m in missing]} written by rank 0; a mesh export "
                "needs out_dir on a filesystem shared by every rank")
        return written


# ------------------------------------------------------------ the artifact

_META_FILE = "rcd_torch_meta.json"  # each program's extra file


class _Baked(nn.Module):
    """The program of one process: ``encoder`` is kept out of the module
    tree, so ``torch.export`` bakes the tensors its call reads in as
    constants (the other tower's are not read, so not stored)."""

    def __init__(self, encoder: _Encoder):
        super().__init__()
        object.__setattr__(self, "encoder", encoder)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.encoder(x)


class _WeightsAsInputs(nn.Module):
    """The program of a mesh rank: ``encoder``'s parameters and buffers are
    the call's first argument, a tuple in ``names``' order (``strict``: no
    tensor of the model is baked in)."""

    def __init__(self, encoder: _Encoder, names: Tuple[str, ...]):
        super().__init__()
        object.__setattr__(self, "encoder", encoder)
        self.names = tuple("model." + n for n in names)

    def forward(self, weights: Tuple[torch.Tensor, ...], x: torch.Tensor) -> torch.Tensor:
        return torch.func.functional_call(self.encoder, dict(zip(self.names, weights)), (x,),
                                          strict=True)


def _trace(program: nn.Module, args: tuple):
    """``torch.export`` of ``program`` at ``args``' static shapes, without
    the example inputs (a mesh program's would be its weights). An int8
    weight is dequantized once a call, where it is read (each read of a
    parametrized attribute would trace its own)."""
    from torch.nn.utils import parametrize

    with torch.no_grad(), parametrize.cached():
        exported = torch.export.export(program, args, strict=False)
    exported.example_inputs = None
    _drop_no_ops(exported.graph_module)
    return exported


def _drop_no_ops(graph_module) -> None:
    """Removes the traced metadata asserts and each cast to the dtype its
    input has: eager PyTorch returns the tensor itself there, the program
    would make a call each (400 in ViT-B-16's text tower, about as many as
    its other ops)."""
    graph = graph_module.graph
    for node in list(graph.nodes):
        if node.target is torch.ops.aten._assert_tensor_metadata.default:
            graph.erase_node(node)
        elif (node.target is torch.ops.aten.to.dtype and len(node.args) == 2
              and not node.kwargs
              and getattr(node.args[0].meta.get("val"), "dtype", None) == node.args[1]):
            node.replace_all_uses_with(node.args[0])
            graph.erase_node(node)
    graph.lint()
    graph_module.recompile()


def _program_meta(device: torch.device) -> Dict[str, str]:
    """The extra file of a program: the device it was traced on and the TF32
    flags it runs under (fp32 serving turns them off)."""
    return {_META_FILE: json.dumps({
        "device": str(device),
        "allow_tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                       "cudnn": torch.backends.cudnn.allow_tf32}})}


def _load_program(source):
    """(the program's module, its meta) from a ``.pt2`` path or file; sets
    the TF32 flags it was exported under. Raises where its device is
    missing."""
    from . import ops  # noqa: F401  (registers the rcd_torch:: ops the graph calls)

    extra = {_META_FILE: ""}
    exported = torch.export.load(source, extra_files=extra)
    meta = json.loads(extra[_META_FILE])
    device = torch.device(meta["device"])
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"the program was exported on {device}, and this process has no "
                           "CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = meta["allow_tf32"]["matmul"]
    torch.backends.cudnn.allow_tf32 = meta["allow_tf32"]["cudnn"]
    return exported, meta


def load_exported(path: str):
    """Reload one exported encoder of a one-process engine: a callable from
    a batch (a tensor or array of the bucket's shape) to its features, on
    the device it was traced on. ``run.program`` is the reloaded module."""
    exported, meta = _load_program(path)
    program, device = exported.module(), torch.device(meta["device"])

    def run(x) -> torch.Tensor:
        with torch.no_grad():
            return program(torch.as_tensor(x, device=device))

    run.program = program
    return run


# (abspath(out_dir), freshness, mesh) -> (manifest, this rank's tensors on its
# device): every encoder and bucket loaded from one artifact onto one mesh
# shares one copy of the weights; a re-export to the same directory misses,
# and its older entries are dropped
_SHARDED_PARAMS_CACHE: Dict[tuple, tuple] = {}


def _artifact_freshness(out_dir: str) -> tuple:
    """The mtime and size of the manifest and ``params.npz``, and the
    manifest's ``export_id`` (a re-export that mtime and size miss)."""
    token = []
    for name in ("sharding_manifest.json", "params.npz"):
        st = os.stat(os.path.join(out_dir, name))
        token.append((name, st.st_mtime_ns, st.st_size))
    with open(os.path.join(out_dir, "sharding_manifest.json")) as f:
        token.append(("export_id", json.load(f)["export_id"]))
    return tuple(token)


def _rank_device(device_type: str) -> torch.device:
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("the artifact was exported on CUDA, and this process has no "
                               "CUDA device")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device_type)


def _load_sharded_params(out_dir: str, mesh, device_type: str) -> tuple:
    """(manifest, this rank's part of every tensor on its device), cached."""
    from .parallel.mesh import MODEL_AXIS
    from .parallel.tensor import Split, split_tensor

    base = os.path.abspath(out_dir)
    fresh = _artifact_freshness(out_dir)
    key = (base, fresh, mesh)
    hit = _SHARDED_PARAMS_CACHE.get(key)
    if hit is not None:
        return hit
    for stale in [k for k in _SHARDED_PARAMS_CACHE if k[0] == base and k[1] != fresh]:
        del _SHARDED_PARAMS_CACHE[stale]
    with open(os.path.join(out_dir, "sharding_manifest.json")) as f:
        manifest = json.load(f)
    want = manifest["mesh_axes"]
    have = {name: mesh[name].size() for name in mesh.mesh_dim_names}
    if have != want:
        raise ValueError(f"mesh mismatch: the artifact was exported on mesh axes {want}, got "
                         f"{have} (each rank's program is the one of its place in that mesh)")
    world, rank = mesh[MODEL_AXIS].size(), mesh[MODEL_AXIS].get_local_rank()
    device = _rank_device(device_type)
    tensors = []
    with np.load(os.path.join(out_dir, "params.npz")) as data:
        for i, entry in enumerate(manifest["params"]):
            whole = torch.from_numpy(data[f"param_{i:05d}"])
            if entry["dtype"] == "bfloat16":
                whole = whole.view(torch.int16).view(torch.bfloat16)  # the stored bits
            if entry["split"] is not None:
                whole = split_tensor(whole, Split(**entry["split"]), world, rank)
            tensors.append(whole.to(device))
    _SHARDED_PARAMS_CACHE[key] = (manifest, tuple(tensors))
    return manifest, tuple(tensors)


def _bind_collectives(program, exported_group: str, group) -> None:
    """Points every ``_c10d_functional`` collective of ``program``'s graph
    at ``group``: the graph names its group by the name it had at export
    (``exported_group``), which another process or mesh gives another group.
    Raises on a collective of any other group."""
    name = group.group_name
    for node in program.graph.nodes:
        target = node.target
        if node.op != "call_function" or getattr(target, "namespace", None) != "_c10d_functional":
            continue
        fields = [a.name for a in target._schema.arguments]
        if "group_name" not in fields:
            continue  # wait_tensor
        i = fields.index("group_name")
        old = node.args[i] if i < len(node.args) else node.kwargs.get("group_name")
        if old not in (exported_group, name):
            raise ValueError(f"{node.name}: a collective over group {old!r}, not the model "
                             f"group the artifact was exported with ({exported_group!r})")
        if i < len(node.args):
            node.args = node.args[:i] + (name,) + node.args[i + 1:]
        else:
            node.kwargs = {**node.kwargs, "group_name": name}
    program.recompile()


def load_exported_sharded(out_dir: str, name: str, mesh):
    """Reload one encoder (e.g. ``encode_image_b8``) that a mesh engine
    exported, onto ``mesh``, which must have the exporting mesh's axes and
    sizes (``ValueError`` otherwise). Every rank calls it, and then calls
    the returned ``run(x)`` with the same full batch: each rank runs its
    data group's rows and every rank gets the whole batch's features back.
    This rank's parts of the weights are placed once per (directory,
    freshness, mesh) and shared by every encoder and bucket loaded from
    there. ``run.program`` is the reloaded module."""
    import torch.distributed as dist

    from .parallel.mesh import DATA_AXIS, MODEL_AXIS

    exported, meta = _load_program(os.path.join(out_dir, f"{name}.pt2"))
    device = torch.device(meta["device"])
    manifest, weights = _load_sharded_params(out_dir, mesh, device.type)
    local = weights[0].device if weights else _rank_device(device.type)
    if local != device:
        from torch.export.passes import move_to_device_pass

        exported = move_to_device_pass(exported, local)  # rank 0 traced on its own card
    program = exported.module()
    _bind_collectives(program, manifest["model_group"], mesh[MODEL_AXIS].get_group())
    ndata, data_rank = mesh[DATA_AXIS].size(), mesh[DATA_AXIS].get_local_rank()
    data_group = mesh[DATA_AXIS].get_group()

    def run(x) -> torch.Tensor:
        x = torch.as_tensor(x, device=local)
        per = x.shape[0] // ndata
        with torch.no_grad():
            out = program(weights, x[data_rank * per:(data_rank + 1) * per].contiguous())
        if ndata == 1:
            return out
        parts = [torch.empty_like(out) for _ in range(ndata)]
        dist.all_gather(parts, out, group=data_group)
        return torch.cat(parts)

    run.program = program
    return run


def create_engine(model_name: str, pretrained: Optional[str] = None,
                  checkpoint: Optional[str] = None, buckets: Sequence[int] = DEFAULT_BUCKETS,
                  dtype: torch.dtype = torch.bfloat16, quantize: Optional[str] = None,
                  warm: bool = True, mesh=None, device="cuda", seed: int = 0,
                  cache_dir: Optional[str] = None):
    """Registry name (+ a pretrained tag, + a checkpoint file loaded over
    it) -> (engine, preprocess, tokenizer), the serving bundle, on
    ``device`` ("cuda" unless asked otherwise; raises when that device is
    missing), as ``tpu/inference.py:create_engine``. Without either the
    weights are a seeded random init. Under a ``mesh`` every rank calls
    this, and only rank 0's ``warm`` runs (it runs every rank's)."""
    from .models.factory import create_model_and_transforms, get_tokenizer, load_checkpoint

    model, preprocess = create_model_and_transforms(
        model_name, pretrained=pretrained, device=device, seed=seed, cache_dir=cache_dir)
    if checkpoint:
        load_checkpoint(model, checkpoint, strict=True)
    engine = ClipInferenceEngine(model, image_size=model.visual.image_size,
                                 context_length=model.context_length, buckets=buckets,
                                 dtype=dtype, quantize=quantize, mesh=mesh)
    if warm:
        engine.warmup()
    return engine, preprocess, get_tokenizer(model_name, cache_dir=cache_dir)
