"""The training objectives: contrastive CLIP, SigLIP, CoCa's, CyCLIP,
distillation and the DINO-soft loss, and open_clip's loss classes."""

from .compat import (
    ClipLoss,
    ClipLossWithDINOEnhancements,
    CoCaLoss,
    CyCLIPLoss,
    DistillClipLoss,
    SigLipLoss,
    create_loss,
)
from .contrastive import (
    clip_logits,
    clip_loss,
    coca_loss,
    cross_entropy,
    cyclip_loss,
    distill_clip_loss,
    gather_features,
    siglip_loss,
)
from .dino import (
    DinoLossCfg,
    DinoProjectionHead,
    apply_projection,
    compute_student_tau,
    dino_enhanced_loss,
)
