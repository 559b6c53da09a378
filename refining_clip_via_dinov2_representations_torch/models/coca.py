"""CoCa, the contrastive captioner, and its caption generation.

The port of the JAX package's ``models/coca.py``. ``CoCa`` holds open_clip's
layout: ``visual`` (the ViT with an attentional pooler and token outputs),
``text`` (the text tower with an appended CLS), ``text_decoder`` (the
multimodal decoder, ``models/transformer.py:MultimodalTransformer``) and
``logit_scale``. Its forward is teacher-forced as in JAX: ``logits`` of the
decoder over ``token_embs[:, :-1]`` and ``labels = text[:, 1:]``. The
decoder's ``text_projection`` is initialised normal with std
``width ** -0.5``, as the JAX decoder's (open_clip leaves it uninitialised).

Generation keeps the JAX package's fixed-length formulation, so the tokens
match it token for token: ``seq_len - 1`` steps, every step's state on the
model's device and no host synchronisation inside the loop (the loop's
positions are Python integers). ``generate`` is greedy, top-k or top-p
sampling (min length, repetition penalty, prompt continuation);
``generate_beam`` is the grouped beam search whose semantics
``tpu/models/coca.py:435-489`` lists: raw-logit beam scores, a -1e9 start
for each group's non-first beams, per-group hypothesis pools, the
early_stopping=False stop rule, finalize with ties to the first group. With
``use_cache`` (the default) each step decodes one token through per-layer
KV caches (reordered with the beams) and cross K/V computed once; without
it each step re-runs the towers over the whole buffer. The decode steps'
attention is plain, as the JAX package routes it (``models/layers.py:
MultiheadAttention``); the image tower runs the fused kernel. Under a
model group the caches hold this rank's heads, and every rank chooses the
same tokens: the logits come after the all-reduces, equal on every rank.

Ties in a top-k resolve to the lowest index, as ``jax.lax.top_k``: the
port sorts stably. Sampling draws from a ``torch.Generator`` (Gumbel-max
over the warped logits, as ``jax.random.categorical``), one draw a sampled
position, so the cached and the uncached routes draw alike; the draws are
the generator's, not JAX's.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..constants import DEFAULT_INIT_LOGIT_SCALE
from .config import CLIPTextCfg, CLIPVisionCfg, MultimodalCfg
from .layers import gelu, quick_gelu
from .transformer import MultimodalTransformer, remat_args


class CoCa(nn.Module):
    """Contrastive captioner. ``dtype`` is the compute dtype; parameters
    are fp32."""

    def __init__(self, embed_dim: int, vision_cfg: CLIPVisionCfg, text_cfg: CLIPTextCfg,
                 multimodal_cfg: MultimodalCfg, quick_gelu_act: bool = False,
                 init_logit_scale: float = DEFAULT_INIT_LOGIT_SCALE,
                 init_logit_bias: Optional[float] = None, dtype: torch.dtype = torch.float32,
                 attn_impl: str = "auto", grad_checkpointing: Union[bool, str] = False):
        super().__init__()
        from .clip import _build_text_tower, _build_vision_tower

        remat, policy = remat_args(grad_checkpointing)
        self.embed_dim = embed_dim
        self.visual = _build_vision_tower(embed_dim, vision_cfg, quick_gelu_act, dtype,
                                          attn_impl, remat, policy)
        self.text = _build_text_tower(embed_dim, text_cfg, quick_gelu_act, dtype, attn_impl,
                                      remat, policy, coca=True)
        if not (vision_cfg.output_tokens and text_cfg.output_tokens):
            raise ValueError("CoCa needs output_tokens in its vision and text configs")
        self.text_decoder = MultimodalTransformer(
            width=multimodal_cfg.width, layers=multimodal_cfg.layers,
            heads=multimodal_cfg.heads, context_length=multimodal_cfg.context_length,
            mlp_ratio=multimodal_cfg.mlp_ratio, ls_init_value=multimodal_cfg.ls_init_value,
            output_dim=text_cfg.vocab_size,  # the decoder projects to the vocabulary
            act=quick_gelu if quick_gelu_act else gelu, attn_impl=attn_impl,
            grad_checkpointing=remat, remat_policy=policy)
        self.text_cfg, self.multimodal_cfg = text_cfg, multimodal_cfg
        self.pad_id = text_cfg.pad_id
        self.context_length = text_cfg.context_length
        self.compute_dtype = dtype
        self.custom_text = True  # open_clip builds CoCa with CustomTextCLIP's text semantics
        self.logit_scale = nn.Parameter(torch.tensor(float(init_logit_scale)))
        self.logit_bias = (None if init_logit_bias is None
                           else nn.Parameter(torch.tensor(float(init_logit_bias))))

    def set_grad_checkpointing(self, enable: bool = True) -> None:
        """Per-block activation checkpointing in all three towers."""
        self.visual.set_grad_checkpointing(enable)
        self.text.set_grad_checkpointing(enable)
        self.text_decoder.grad_checkpointing = enable

    def _encode_image(self, images: torch.Tensor, normalize: bool = True,
                      patch_dropout_generator: Optional[torch.Generator] = None):
        latent, tokens = self.visual(images, patch_dropout_generator)
        return (F.normalize(latent, dim=-1) if normalize else latent), tokens

    def _encode_text(self, text: torch.Tensor, normalize: bool = True):
        latent, token_embs = self.text(text)
        return (F.normalize(latent, dim=-1) if normalize else latent), token_embs

    def encode_image(self, images: torch.Tensor, normalize: bool = True,
                     patch_dropout_generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self._encode_image(images, normalize, patch_dropout_generator)[0]

    def encode_text(self, text: torch.Tensor, normalize: bool = True) -> torch.Tensor:
        return self._encode_text(text, normalize)[0]

    def decode_logits(self, image: torch.Tensor, text: torch.Tensor) -> torch.Tensor:
        """Caption logits of a whole (image, text prefix) pair: the decode
        primitive of the uncached generation."""
        _, image_embs = self._encode_image(image)
        _, token_embs = self._encode_text(text)
        return self.text_decoder(image_embs, token_embs)

    def forward(self, image: torch.Tensor, text: Optional[torch.Tensor] = None,
                patch_dropout_generator: Optional[torch.Generator] = None,
                output_labels: bool = True) -> dict:
        image_latent, image_embs = self._encode_image(image,
                                                      patch_dropout_generator=patch_dropout_generator)
        if text is None:
            return {"image_features": image_latent, "image_embs": image_embs}
        text_latent, token_embs = self._encode_text(text)
        labels = None
        if output_labels:
            # teacher forcing: logits at position i predict token i + 1
            labels, token_embs = text[:, 1:], token_embs[:, :-1]
        out = {"image_features": image_latent, "text_features": text_latent,
               "logits": self.text_decoder(image_embs, token_embs),
               "logit_scale": self.logit_scale.exp()}
        if labels is not None:
            out["labels"] = labels
        if self.logit_bias is not None:
            out["logit_bias"] = self.logit_bias
        return out


def _apply_repetition_penalty(logits: torch.Tensor, seen: torch.Tensor,
                              penalty: float) -> torch.Tensor:
    """HF's ``RepetitionPenaltyLogitsProcessor``: seen tokens' scores times
    ``penalty`` where negative, over it where positive."""
    penalized = torch.where(logits < 0, logits * penalty, logits / penalty)
    return torch.where(seen, penalized, logits)


def top_k_filter(logits: torch.Tensor, top_k: int) -> torch.Tensor:
    """HF's ``TopKLogitsWarper``: logits below the k-th largest to -inf
    (ties with the k-th survive). [..., V] -> [..., V]."""
    kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
    return logits.masked_fill(logits < kth, float("-inf"))


def top_p_filter(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """HF's ``TopPLogitsWarper``: keep the smallest descending set whose
    cumulative softmax reaches ``top_p`` (the boundary token kept), the rest
    to -inf. [..., V] -> [..., V]."""
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
    cutoff_idx = (cum < top_p).sum(dim=-1, keepdim=True).clamp(max=logits.shape[-1] - 1)
    cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
    return logits.masked_fill(logits < cutoff, float("-inf"))


def _stable_top_k(x: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis, descending,
    ties to the lower index (``jax.lax.top_k``'s order)."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def _categorical(logits: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """One draw a row from softmax(``logits``) by Gumbel-max over uniforms
    from ``generator`` (drawn on its device)."""
    u = torch.rand(logits.shape, generator=generator, device=generator.device)
    u = u.to(logits.device).clamp_(min=torch.finfo(torch.float32).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def _init_caches(model: CoCa, b: int, cfg, length: int, dtype, device):
    """Zeroed per-layer (k, v) caches of a tower, [B, H, L, Dh] each: this
    rank's heads under a model group (``parallel/tensor.py:shard_module``),
    as its attention layers project them."""
    mp = getattr(model, "model_parallel", None)
    shape = (b, cfg.heads // (mp.world if mp else 1), length, cfg.width // cfg.heads)
    return [(torch.zeros(shape, dtype=dtype, device=device),
             torch.zeros(shape, dtype=dtype, device=device)) for _ in range(cfg.layers)]


def _check_context(model: CoCa, seq_len: int) -> None:
    ctx = model.text_cfg.context_length
    if seq_len > ctx:
        # the fixed decode buffer has no sliding window: past the positional
        # table the cached route would read the wrong rows
        raise ValueError(f"seq_len {seq_len} exceeds the text tower's context_length {ctx}")


@torch.no_grad()
def generate(model: CoCa, image: torch.Tensor, text: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None, seq_len: int = 30,
             temperature: float = 1.0, generation_type: str = "beam_search",
             top_p: float = 0.1, top_k: int = 1, sot_token_id: int = 49406,
             eot_token_id: int = 49407, pad_token_id: int = 0, num_beams: int = 6,
             num_beam_groups: int = 3, min_seq_len: int = 5, repetition_penalty: float = 1.0,
             length_penalty: float = 1.0, use_cache: bool = True) -> torch.Tensor:
    """Fixed-length caption generation (``tpu/models/coca.py:201-432``):
    ``"beam_search"`` (``generate_beam``), ``"top_k"`` (k = 1: greedy) or
    ``"top_p"``. Per position: no EOT before ``min_seq_len``, the
    repetition penalty, the warp on the raw logits, the temperature, the
    draw; EOT forced at the last position, PAD for finished rows (a sampled
    EOT or PAD finishes a row). ``text`` ([B, P] or [P], one prompt tiled
    over the batch) is continued; the beam search ignores it. Returns
    [B, seq_len] token ids (int64). ``generator`` drives the draws (one on
    the images' device, seeded 0, when none is given)."""
    if seq_len <= min_seq_len:
        raise ValueError("seq_len must be larger than min_seq_len")
    if generation_type == "beam_search":
        return generate_beam(model, image, num_beams=num_beams,
                             num_beam_groups=num_beam_groups, seq_len=seq_len,
                             sot_token_id=sot_token_id, eot_token_id=eot_token_id,
                             pad_token_id=pad_token_id, min_seq_len=min_seq_len,
                             repetition_penalty=repetition_penalty,
                             length_penalty=length_penalty, use_cache=use_cache)
    if generation_type not in ("top_k", "top_p"):
        raise ValueError(f"generation_type {generation_type!r} not supported; use "
                         "'beam_search', 'top_k' (k=1 for greedy) or 'top_p'")
    _check_context(model, seq_len)
    device = image.device
    b = image.shape[0]
    vocab = model.text_cfg.vocab_size
    use_rep = repetition_penalty != 1.0
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    _, image_embs = model._encode_image(image)

    tokens = torch.full((b, seq_len), pad_token_id, dtype=torch.long, device=device)
    seen = None
    if text is not None:
        prompt = torch.as_tensor(text, device=device).long()
        if prompt.dim() == 1:
            prompt = prompt[None]
        if prompt.shape[0] == 1 and b > 1:
            prompt = prompt.expand(b, -1)
        start = prompt.shape[1]
        if not 0 < start < seq_len:
            raise ValueError(f"prompt length {start} must be in [1, seq_len={seq_len})")
        tokens[:, :start] = prompt
        # a prompt ending in EOT or PAD is finished
        finished = (prompt[:, -1] == eot_token_id) | (prompt[:, -1] == pad_token_id)
        if use_rep:
            seen = torch.zeros(b, vocab, dtype=torch.bool, device=device)
            seen.scatter_(1, prompt, True)
    else:
        start = 1
        tokens[:, 0] = sot_token_id
        finished = torch.zeros(b, dtype=torch.bool, device=device)
        if use_rep:
            seen = torch.zeros(b, vocab, dtype=torch.bool, device=device)
            seen[:, sot_token_id] = True

    def choose(step_logits: torch.Tensor, tw: int, finished: torch.Tensor, seen):
        """The rule of position ``tw``, the one being written."""
        if tw < min_seq_len:
            step_logits[:, eot_token_id] = float("-inf")
        if use_rep:
            step_logits = _apply_repetition_penalty(step_logits, seen, repetition_penalty)
        if generation_type == "top_k":
            step_logits = top_k_filter(step_logits, top_k)
            nxt = (torch.argmax(step_logits, dim=-1) if top_k == 1
                   else _categorical(step_logits / max(temperature, 1e-6), generator))
        else:
            step_logits = top_p_filter(step_logits, top_p)
            nxt = _categorical(step_logits / max(temperature, 1e-6), generator)
        if tw == seq_len - 1:
            nxt = torch.full_like(nxt, eot_token_id)
        return torch.where(finished, pad_token_id, nxt)

    def advance(tokens, finished, seen, nxt, tw):
        tokens[:, tw] = nxt
        # a sampled PAD also finishes the row, as in the reference
        finished = finished | (nxt == eot_token_id) | (nxt == pad_token_id)
        if use_rep:
            seen = seen.scatter(1, nxt[:, None], True)
        return finished, seen

    if use_cache:
        dtype = model.compute_dtype
        tcaches = _init_caches(model, b, model.text_cfg, seq_len, dtype, device)
        dcaches = _init_caches(model, b, model.multimodal_cfg, seq_len, dtype, device)
        cross = model.text_decoder(image_embs, None, compute_cross_kv=True)
        cur = tokens[:, 0:1]
        # position 0 onwards, so a prompt's tokens prefill the caches
        for t in range(seq_len - 1):
            emb, tcaches = model.text(cur, caches=tcaches, pos=t)
            logits, dcaches = model.text_decoder(None, emb, caches=dcaches, pos=t,
                                                 cross_caches=cross)
            tw = t + 1  # logits at position t predict token t + 1
            if tw < start:  # prompt prefill: the token is given
                cur = tokens[:, tw:tw + 1]
                continue
            nxt = choose(logits[:, 0].float(), tw, finished, seen)
            finished, seen = advance(tokens, finished, seen, nxt, tw)
            cur = nxt[:, None]
        return tokens

    for t in range(start, seq_len):
        logits = model.text_decoder(image_embs, model._encode_text(tokens)[1])
        nxt = choose(logits[:, min(t - 1, logits.shape[1] - 1)].float(), t, finished, seen)
        finished, seen = advance(tokens, finished, seen, nxt, t)
    return tokens


@torch.no_grad()
def generate_beam(model: CoCa, image: torch.Tensor, num_beams: int = 6,
                  num_beam_groups: int = 3, seq_len: int = 30, sot_token_id: int = 49406,
                  eot_token_id: int = 49407, pad_token_id: int = 0, min_seq_len: int = 5,
                  repetition_penalty: float = 1.0, length_penalty: float = 1.0,
                  log_softmax_scores: bool = False, use_cache: bool = True) -> torch.Tensor:
    """Grouped beam search with fixed length (``tpu/models/coca.py:435-724``):
    ``num_beams`` beams in ``num_beam_groups`` independent groups; scores
    are sums of raw logits (``log_softmax_scores`` for log-probabilities);
    each step a group takes its top ``2 * group_size`` candidates, EOT
    candidates ranked below ``group_size`` join its hypothesis pool at
    ``score / (tw + 1) ** length_penalty`` and the best non-EOT candidates
    refill its beams; a group stops once its pool is full and its worst
    entry reaches the best candidate's normalised score; at the end live
    beams of unfinished groups join at the full length and the best pooled
    hypothesis (ties to the first group) is returned with EOT appended where
    it fits. [B, seq_len] int64."""
    b, w, g = image.shape[0], num_beams, num_beam_groups
    if w <= 1:
        raise ValueError("num_beams must be > 1 (use top_k=1 for greedy)")
    if g > w or w % g != 0:
        raise ValueError(f"num_beam_groups must divide num_beams (got {g} groups of {w} beams)")
    if seq_len <= min_seq_len:
        raise ValueError("seq_len must be larger than min_seq_len")
    _check_context(model, seq_len)
    s, L = w // g, seq_len
    vocab = model.text_cfg.vocab_size
    use_rep = repetition_penalty != 1.0
    device = image.device
    f32 = dict(dtype=torch.float32, device=device)
    _, image_embs = model._encode_image(image)
    image_embs_rep = image_embs.repeat_interleave(w, dim=0)  # [B*W, T, D]

    # live beams, groups-major: beam j belongs to group j // s
    tokens = torch.full((b, w, L), pad_token_id, dtype=torch.long, device=device)
    tokens[:, :, 0] = sot_token_id
    first = torch.arange(w, device=device) % s == 0
    scores = torch.where(first, torch.tensor(0.0, **f32), torch.tensor(-1e9, **f32)).expand(
        b, w).clone()
    done = torch.zeros(b, g, dtype=torch.bool, device=device)
    # per-group hypothesis pool, S slots kept sorted best first
    pool = (torch.full((b, g, s), float("-inf"), **f32),
            torch.full((b, g, s, L), pad_token_id, dtype=torch.long, device=device),
            torch.zeros(b, g, s, dtype=torch.long, device=device))
    seen = None
    if use_rep:
        seen = torch.zeros(b, w, vocab, dtype=torch.bool, device=device)
        seen[:, :, sot_token_id] = True
    arange_s = torch.arange(s, device=device)
    positions = torch.arange(L, device=device)

    def merge_pool(pool, adds):
        """The best S of the pool and the adds; the pool's slots first, so
        ties keep what is there."""
        sc = torch.cat([pool[0], adds[0]], dim=2)
        tok = torch.cat([pool[1], adds[1]], dim=2)
        length = torch.cat([pool[2], adds[2]], dim=2)
        new_sc, keep = _stable_top_k(sc, s)
        return (new_sc, torch.gather(tok, 2, keep[..., None].expand(-1, -1, -1, L)),
                torch.gather(length, 2, keep))

    def process(step, tw: int, tokens, scores, done, pool, seen):
        """One scorer step on the raw logits ``step`` [B, W, V] of the
        position before ``tw``; returns the new state and the beam source
        and written token, which reorder the caches."""
        if log_softmax_scores:
            step = torch.log_softmax(step, dim=-1)
        if tw < min_seq_len:
            step[..., eot_token_id] = float("-inf")
        if use_rep:
            step = _apply_repetition_penalty(step, seen, repetition_penalty)
        cand = (scores[:, :, None] + step).reshape(b, g, s * vocab)
        top_sc, top_ix = _stable_top_k(cand, 2 * s)  # [B, G, 2S]
        src, tok = top_ix // vocab, top_ix % vocab
        is_eot = tok == eot_token_id
        # the first S non-EOT candidates, in rank order, refill the beams
        rank = torch.arange(2 * s, device=device)
        sel = torch.argsort(rank + is_eot.long() * (4 * s), dim=-1)[..., :s]
        live_sc, live_tok, live_src = (torch.gather(x, -1, sel) for x in (top_sc, tok, src))
        # EOT candidates ranked below S join the pool
        add_mask = is_eot[..., :s] & ~done[..., None]
        norm = torch.tensor(float(tw + 1), **f32) ** length_penalty  # prefix + the EOT
        add_sc = torch.where(add_mask, top_sc[..., :s] / norm, torch.tensor(float("-inf"), **f32))
        tok_g = tokens.reshape(b, g, s, L)
        add_tok = torch.gather(tok_g, 2, src[..., :s, None].expand(-1, -1, -1, L))
        add_tok = torch.where(positions < tw, add_tok, pad_token_id)
        add_len = torch.where(add_mask, tw, 0)
        pool = merge_pool(pool, (add_sc, add_tok, add_len))
        # BeamHypotheses.is_done with early_stopping=False
        full = (pool[0] > float("-inf")).sum(-1) >= s
        done = done | (full & (pool[0][..., -1] >= top_sc[..., 0] / norm))
        # done groups freeze: identity reorder, PAD written
        idx = torch.where(done[..., None], arange_s, live_src)
        tok_g = torch.gather(tok_g, 2, idx[..., None].expand(-1, -1, -1, L))
        write_tok = torch.where(done[..., None], pad_token_id, live_tok)
        tok_g[:, :, :, tw] = write_tok
        scores = torch.where(done[..., None], scores.reshape(b, g, s), live_sc).reshape(b, w)
        if use_rep:
            seen = torch.gather(seen.reshape(b, g, s, vocab), 2,
                                idx[..., None].expand(-1, -1, -1, vocab))
            seen = seen.scatter(3, write_tok[..., None], True).reshape(b, w, vocab)
        return tok_g.reshape(b, w, L), scores, done, pool, seen, idx, write_tok

    if use_cache:
        dtype = model.compute_dtype
        tcaches = _init_caches(model, b * w, model.text_cfg, L, dtype, device)
        dcaches = _init_caches(model, b * w, model.multimodal_cfg, L, dtype, device)
        # the image tokens' cross K/V: projected once, the same for every beam
        cross = model.text_decoder(image_embs_rep, None, compute_cross_kv=True)
        cur = tokens.reshape(b * w, L)[:, 0:1]

        def reorder(cache, idx):
            def take(a):
                a = a.reshape(b, g, s, *a.shape[1:])
                a = torch.gather(a, 2, idx.reshape(b, g, s, 1, 1, 1).expand_as(a))
                return a.reshape(b * w, *a.shape[3:])

            return take(cache[0]), take(cache[1])

        for t in range(L - 1):
            emb, tcaches = model.text(cur, caches=tcaches, pos=t)
            logits, dcaches = model.text_decoder(None, emb, caches=dcaches, pos=t,
                                                 cross_caches=cross)
            step = logits[:, 0].float().reshape(b, w, vocab)
            tokens, scores, done, pool, seen, idx, write_tok = process(
                step, t + 1, tokens, scores, done, pool, seen)
            tcaches = [reorder(c, idx) for c in tcaches]
            dcaches = [reorder(c, idx) for c in dcaches]
            cur = write_tok.reshape(b * w, 1)
    else:
        for t in range(1, L):
            logits = model.text_decoder(image_embs_rep,
                                        model._encode_text(tokens.reshape(b * w, L))[1])
            step = logits[:, min(t - 1, logits.shape[1] - 1)].float().reshape(b, w, vocab)
            tokens, scores, done, pool, seen, _, _ = process(step, t, tokens, scores, done,
                                                             pool, seen)

    # finalize: live beams of unfinished groups join the pool at the full length
    norm = torch.tensor(float(L), **f32) ** length_penalty
    fin_sc = torch.where(~done[..., None], scores.reshape(b, g, s) / norm,
                         torch.tensor(float("-inf"), **f32))
    fin_len = torch.where(~done[..., None], L, 0).expand(b, g, s)
    hyp_sc, hyp_tok, hyp_len = merge_pool(pool, (fin_sc, tokens.reshape(b, g, s, L), fin_len))
    best = torch.argmax(hyp_sc.reshape(b, g * s), dim=-1)  # first maximum: first group
    rows = torch.arange(b, device=device)
    best_tok = hyp_tok.reshape(b, g * s, L)[rows, best]
    best_len = hyp_len.reshape(b, g * s)[rows, best][:, None]
    return torch.where(positions < best_len, best_tok,
                       torch.where(positions == best_len, eot_token_id, pad_token_id))
