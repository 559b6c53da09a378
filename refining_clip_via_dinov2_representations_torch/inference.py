"""Serving engine: bucketed batching over the two towers on one device.

The port of the JAX package's ``inference.py`` ``ClipInferenceEngine``
(single device, no quantisation). Requests are padded up to a small ladder
of batch buckets, so the device sees a few fixed shapes; larger requests are
chunked by the top bucket. ``warmup`` runs every (tower, bucket) once, which
on the card also builds the CUDA kernels before the first request.

Precision follows the JAX engine: images are rounded to the engine dtype
(bf16 by default) on the device, then the model casts them to its compute
dtype (fp32 under the default precision); features are L2-normalised in
fp32 (a CoCa engine's are its normalised latents). ``caption_tokens``
captions images with a CoCa model's grouped beam search
(``models/coca.py:generate_beam``), bucketed like the encoders. Int8
weights, meshes and StableHLO export are not ported yet (ROADMAP).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

DEFAULT_BUCKETS = (1, 8, 32, 128)
_CAPTION_MAX_BEAMS = 16  # the JAX engine's cap on a request's beam width


def _bucket_for(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


class ClipInferenceEngine:
    """Bucketed two-tower encoder.

    Args:
      model: a built ``models.clip.CLIP`` on its serving device.
      image_size: (H, W) expected by the vision tower.
      context_length: text sequence length (77 for CLIP BPE).
      buckets: ascending batch-size ladder.
      dtype: the dtype images are rounded to before the vision tower.
    """

    def __init__(self, model, image_size: Tuple[int, int] = (224, 224),
                 context_length: int = 77, buckets: Sequence[int] = DEFAULT_BUCKETS,
                 dtype: torch.dtype = torch.bfloat16):
        self.model = model.eval()
        self.device = model.logit_scale.device
        self.image_size = tuple(image_size)
        self.context_length = int(context_length)
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        self.dtype = dtype
        if self.device.type == "cuda" and model.compute_dtype == torch.float32:
            # fp32 serving stays fp32: TF32 keeps ~3 decimal digits
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False

    def _encode_image(self, images: torch.Tensor) -> torch.Tensor:
        feats = self.model.encode_image(images.to(self.dtype), normalize=False).float()
        return feats / feats.norm(dim=-1, keepdim=True)

    def _encode_text(self, texts: torch.Tensor) -> torch.Tensor:
        feats = self.model.encode_text(texts.long(), normalize=False).float()
        return feats / feats.norm(dim=-1, keepdim=True)

    def _run_bucketed(self, fn, x: np.ndarray) -> np.ndarray:
        """Pad to the bucket, run, slice back; chunk past the top bucket."""
        n, top = x.shape[0], self.buckets[-1]
        if n > top:
            return np.concatenate([self._run_bucketed(fn, x[i:i + top])
                                   for i in range(0, n, top)], axis=0)
        b = _bucket_for(n, self.buckets)
        if b != n:
            x = np.concatenate([x, np.zeros((b - n, *x.shape[1:]), x.dtype)], axis=0)
        with torch.inference_mode():
            out = fn(torch.from_numpy(np.ascontiguousarray(x)).to(self.device))
            return out.cpu().numpy()[:n]

    def encode_image(self, images: np.ndarray) -> np.ndarray:
        """[N,H,W,3] float (0-mean preprocessed) -> [N,D] unit vectors."""
        return self._run_bucketed(self._encode_image, np.asarray(images, np.float32))

    def encode_text(self, texts: np.ndarray) -> np.ndarray:
        """[N,L] int32 token ids -> [N,D] unit vectors."""
        return self._run_bucketed(self._encode_text, np.asarray(texts, np.int32))

    def caption_tokens(self, images: np.ndarray, seq_len: int = 30, num_beams: int = 6,
                       num_beam_groups: int = 3, min_seq_len: int = 5,
                       repetition_penalty: float = 1.0, length_penalty: float = 1.0,
                       sot_token_id: int = 49406, eot_token_id: int = 49407,
                       pad_token_id: int = 0) -> np.ndarray:
        """Caption a preprocessed image batch with the grouped beam search
        (CoCa models only; the JAX engine's defaults): [N,H,W,3] floats ->
        [N, seq_len] int32 ids (SOT ... EOT, pad-filled), bucketed and padded
        like the encoders. On the card the image tower runs the fused
        kernel (one launch a layer); the decode steps take plain attention,
        as in the JAX package."""
        from .models.coca import CoCa, generate_beam

        if not isinstance(self.model, CoCa):
            raise TypeError(
                f"caption_tokens requires a CoCa model (got {type(self.model).__name__})")
        if not 1 < num_beams <= _CAPTION_MAX_BEAMS:
            raise ValueError(f"num_beams must be in [2, {_CAPTION_MAX_BEAMS}], got {num_beams}")

        def caption(imgs: torch.Tensor) -> torch.Tensor:
            return generate_beam(
                self.model, imgs.to(self.dtype), num_beams=num_beams,
                num_beam_groups=num_beam_groups, seq_len=seq_len, sot_token_id=sot_token_id,
                eot_token_id=eot_token_id, pad_token_id=pad_token_id, min_seq_len=min_seq_len,
                repetition_penalty=repetition_penalty, length_penalty=length_penalty).int()

        return self._run_bucketed(caption, np.asarray(images, np.float32))

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
        """Run one zero batch per (tower, bucket)."""
        h, w = self.image_size
        for b in self.buckets:
            self.encode_image(np.zeros((b, h, w, 3), np.float32))
            self.encode_text(np.zeros((b, self.context_length), np.int32))


def create_engine(model_name: str, checkpoint: Optional[str] = None,
                  buckets: Sequence[int] = DEFAULT_BUCKETS, warm: bool = True,
                  device="cuda", seed: int = 0):
    """Registry name (+ optional local state-dict checkpoint) -> (engine,
    preprocess, tokenizer), the serving bundle, on ``device`` ("cuda" unless
    asked otherwise; raises when that device is missing). Without a
    checkpoint the weights are a seeded random init."""
    from .models.factory import create_model_and_transforms, get_tokenizer

    model, preprocess = create_model_and_transforms(
        model_name, pretrained=checkpoint, device=device, seed=seed)
    engine = ClipInferenceEngine(model, image_size=model.visual.image_size,
                                 context_length=model.context_length, buckets=buckets)
    if warm:
        engine.warmup()
    return engine, preprocess, get_tokenizer(model_name)
