"""The DINO-soft structural-alignment objective.

The port of the JAX package's ``losses/dino.py`` for one process. Terms:

  (a) classic CLIP CE;
  (b) a projection head CLIP-dim -> DINO-dim (``DinoProjectionHead``), a real
      module whose parameters the optimizer updates (``freeze_projection``
      keeps them fixed for bug-compatible runs);
  (c) DINO-soft KL: the student image-image similarity softmax, at a
      temperature taken from the logit scale, against the frozen teacher's
      similarity softmax (diagonal masked to -inf);
  (d) optionally a text-text KL against the same teacher distribution;
  (e) a weighted CE whose logits are offset by DINO dissimilarity
      (Delta = beta * r_hat, p-centred);
  (f) total = lambda_original (a) + lambda_soft (c + d) + lambda_weighted (e);
  (g) optional diagnostics, computed without gradient.

Dtypes as in JAX: the soft and weighted terms run in fp32; stop-gradients
become ``detach``. ``group`` is a ``torch.distributed`` process group, which
raises until multi-GPU training is ported (see ``losses/contrastive.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..models.layers import LayerNorm
from .contrastive import clip_logits, cross_entropy


def compute_student_tau(logit_scale: torch.Tensor) -> torch.Tensor:
    """Adaptive student temperature, without gradient. Takes the raw
    ln-scale (about 2-5) or an exponentiated scale (about 10-100); the
    threshold between the two is 10."""
    val = logit_scale.detach().float()
    scale_mult = torch.where(val > 10.0, val, torch.exp(val))
    scale_mult = torch.clamp(scale_mult, max=100.0)
    return torch.clamp(1.0 / scale_mult, 0.008, 0.02)


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-12)


@dataclasses.dataclass(frozen=True)
class DinoLossCfg:
    """Knobs of the DINO loss (the training CLI's flag names)."""

    lambda_original: float = 1.0
    lambda_soft: float = 0.0
    soft_mode: str = "kl_teacher"     # none | siglip_dino | kl_teacher
    teacher_temp: float = 0.15
    soft_dino_to_text: bool = False
    text_lambda: float = 0.2
    text_student_temp: float = 0.05
    lambda_weighted: float = 0.0
    rho: float = 0.1
    c_clip: float = 1.0
    weight_text_symmetry: bool = False
    use_projection: bool = True
    projection_type: str = "mlp"      # linear | mlp
    use_layernorm: bool = False
    residual_projection: bool = False
    residual_alpha: Optional[float] = None
    local_loss: bool = True
    with_diagnostics: bool = False


class DinoProjectionHead(nn.Module):
    """CLIP embedding -> DINO embedding, in fp32.

    linear: one Linear (``proj``). mlp: ``fc1`` to (d_in + dino_dim) // 2,
    ReLU, ``fc2``; either optionally followed by a LayerNorm (``ln``). The
    parameter names are the JAX head's, so
    ``models/convert.py:jax_head_params_to_state_dict`` loads strictly."""

    def __init__(self, in_dim: int, dino_dim: int, projection_type: str = "mlp",
                 use_layernorm: bool = False):
        super().__init__()
        self.projection_type = projection_type
        if projection_type == "linear":
            self.proj = nn.Linear(in_dim, dino_dim)
        elif projection_type == "mlp":
            hidden = (in_dim + dino_dim) // 2
            self.fc1 = nn.Linear(in_dim, hidden)
            self.fc2 = nn.Linear(hidden, dino_dim)
        else:
            raise ValueError(f"Unknown projection_type: {projection_type}")
        self.ln = LayerNorm(dino_dim) if use_layernorm else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if self.projection_type == "linear":
            x = self.proj(x)
        else:
            x = self.fc2(F.relu(self.fc1(x)))
        return self.ln(x) if self.ln is not None else x


def apply_projection(image_features: torch.Tensor, raw_proj: Optional[torch.Tensor],
                     cfg: DinoLossCfg) -> torch.Tensor:
    """Residual blending, then normalise."""
    if raw_proj is None:
        return _normalize(image_features)
    if cfg.residual_projection and raw_proj.shape == image_features.shape:
        if cfg.residual_alpha is None:
            return _normalize(image_features + raw_proj)
        a = cfg.residual_alpha
        return _normalize(a * image_features + (1 - a) * raw_proj)
    return _normalize(raw_proj)


def _soft_kl(student_sims: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """KL(q || softmax(student_sims)), batch mean; 0 where q == 0 (the
    masked teacher diagonal), so 0 * log 0 never makes a NaN."""
    log_p = torch.log_softmax(student_sims.float(), dim=1)
    live = q > 0
    log_q = torch.where(live, torch.log(torch.clamp(q, min=1e-38)), torch.zeros_like(q))
    terms = torch.where(live, q * (log_q - log_p), torch.zeros_like(q))
    return terms.sum() / student_sims.shape[0]


def dino_enhanced_loss(
    image_features: torch.Tensor,
    text_features: torch.Tensor,
    logit_scale: torch.Tensor,
    dino_features: Optional[torch.Tensor],
    cfg: DinoLossCfg,
    image_proj: Optional[torch.Tensor] = None,
    group=None,
    lambda_overrides: Optional[Dict[str, float]] = None,
) -> Dict[str, torch.Tensor]:
    """The full DINO-enhanced objective.

    Args:
      image_features / text_features: L2-normalised CLIP outputs.
      dino_features: frozen teacher features for the same batch (not
        necessarily normalised), or None for the classic CE alone.
      image_proj: ``DinoProjectionHead`` output on image_features (before
        normalising); None when the projection is off.
      lambda_overrides: values replacing ``lambda_soft`` /
        ``lambda_weighted`` / ``lambda_original`` / ``rho`` (the train step's
        lambda warm-up).

    Returns total_loss, classic_loss, soft_loss, weighted_loss (and
    ``dbg/*`` scalars when ``cfg.with_diagnostics``).
    """
    b = image_features.shape[0]
    ov = lambda_overrides or {}
    lambda_soft = ov.get("lambda_soft", cfg.lambda_soft)
    lambda_weighted = ov.get("lambda_weighted", cfg.lambda_weighted)
    lambda_original = ov.get("lambda_original", cfg.lambda_original)
    device = image_features.device

    logits_i, logits_t, labels = clip_logits(image_features, text_features, logit_scale,
                                             group, cfg.local_loss)
    classic = 0.5 * (cross_entropy(logits_i, labels) + cross_entropy(logits_t, labels))

    if dino_features is not None and cfg.use_projection:
        zs = apply_projection(image_features, image_proj, cfg)
    else:
        zs = _normalize(image_features)

    out: Dict[str, torch.Tensor] = {}
    eye = torch.eye(b, dtype=torch.bool, device=device)

    # the gate reads the static lambda_soft, not its warmed-up value
    soft = torch.zeros((), dtype=torch.float32, device=device)
    if dino_features is not None and cfg.soft_mode == "kl_teacher" and cfg.lambda_soft > 0.0:
        dn = _normalize(dino_features.float())
        tau_s = compute_student_tau(logit_scale)
        s_student = (zs.float() @ zs.float().T) / tau_s
        s_teacher = ((dn @ dn.T) / cfg.teacher_temp).masked_fill(eye, float("-inf"))
        q = torch.softmax(s_teacher, dim=1).detach()
        soft = _soft_kl(s_student, q)
        if cfg.soft_dino_to_text and cfg.text_lambda > 0.0:
            tn = _normalize(text_features.float())
            s_tt = (tn @ tn.T) / cfg.text_student_temp
            soft = soft + cfg.text_lambda * _soft_kl(s_tt, q)

    weighted = torch.zeros((), dtype=torch.float32, device=device)
    if cfg.lambda_weighted > 0.0 and dino_features is not None and b > 1:
        dn = _normalize(dino_features.float()).detach()
        r = (1.0 - torch.clamp(dn @ dn.T, -1.0, 1.0)).masked_fill(eye, 0.0)
        rho = ov.get("rho", cfg.rho)

        def modulate(logits, r_mat):
            """Add Delta = beta * r_hat to the logits."""
            p_base = torch.softmax(logits.float(), dim=1)
            r_hat = r_mat - (p_base * r_mat).sum(dim=1, keepdim=True)
            r_hat = torch.clamp(r_hat, -cfg.c_clip, cfg.c_clip)
            row_std = torch.std(logits.float(), dim=1, correction=1)
            # the lower middle element for an even count, as torch.median
            sigma = torch.clamp(torch.sort(row_std).values[(row_std.shape[0] - 1) // 2],
                                min=1e-6)
            beta = (rho * sigma / cfg.c_clip).detach()
            delta = (beta * r_hat).masked_fill(eye, 0.0)
            return logits + delta.to(logits.dtype), delta

        logits_i_tilde, delta_img = modulate(logits_i, r)
        ce_img_den = cross_entropy(logits_i_tilde, labels)
        if cfg.weight_text_symmetry:
            logits_t_tilde, delta_txt = modulate(logits_t, r.T)
        else:
            logits_t_tilde, delta_txt = logits_t, None
        ce_txt_den = cross_entropy(logits_t_tilde, labels)
        weighted = 0.5 * (ce_img_den + ce_txt_den)

        if cfg.with_diagnostics:
            dbg = _weighted_diagnostics(logits_i, logits_t, logits_i_tilde, logits_t_tilde,
                                        delta_img, delta_txt, labels, b)
            out.update({f"dbg/{k}": v for k, v in dbg.items()})

    total = lambda_original * classic + lambda_soft * soft + lambda_weighted * weighted
    out.update(total_loss=total, classic_loss=classic, soft_loss=soft,
               weighted_loss=weighted)
    return out


@torch.no_grad()
def _weighted_diagnostics(logits_i, logits_t, logits_i_tilde, logits_t_tilde, delta_img,
                          delta_txt, labels, b) -> Dict[str, torch.Tensor]:
    """Scalar summaries of the weighted-CE modulation."""
    def _sm(x):
        return torch.softmax(x.float(), dim=1)

    p_i, p_it = _sm(logits_i), _sm(logits_i_tilde)
    p_t, p_tt = _sm(logits_t), _sm(logits_t_tilde)
    offdiag = ~torch.eye(b, dtype=torch.bool, device=logits_i.device)

    def rowwise_corr(a, c, eps=1e-9):
        a = a - a.mean(dim=1, keepdim=True)
        c = c - c.mean(dim=1, keepdim=True)
        num = (a * c).sum(dim=1)
        den = torch.sqrt((a * a).sum(dim=1)) * torch.sqrt((c * c).sum(dim=1)) + eps
        return (num / den).mean()

    dbg = {
        "delta_img_max": delta_img.abs().max(),
        "delta_img_mean": delta_img.abs().mean(),
        "l1_prob_shift_img": (p_it - p_i).abs().sum(dim=1).mean(),
        "l1_prob_shift_txt": (p_tt - p_t).abs().sum(dim=1).mean(),
        "ce_img_base": cross_entropy(logits_i, labels),
        "ce_img_mod": cross_entropy(logits_i_tilde, labels),
        "ce_txt_base": cross_entropy(logits_t, labels),
        "ce_txt_mod": cross_entropy(logits_t_tilde, labels),
        "pos_frac_img": (torch.where(offdiag, delta_img, 0.0) > 0).float().mean(),
    }
    if delta_txt is not None:
        dbg.update(delta_txt_max=delta_txt.abs().max(), delta_txt_mean=delta_txt.abs().mean())
    if logits_i.shape[1] == delta_img.shape[1]:
        dbg["corr_rhat_dprob_img"] = rowwise_corr(delta_img, p_it - p_i)
    return dbg
