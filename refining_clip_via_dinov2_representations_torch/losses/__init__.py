"""The training objectives: contrastive CLIP, CoCa's and the DINO-soft loss."""

from .contrastive import clip_logits, clip_loss, coca_loss, cross_entropy, gather_features
from .dino import (
    DinoLossCfg,
    DinoProjectionHead,
    apply_projection,
    compute_student_tau,
    dino_enhanced_loss,
)
