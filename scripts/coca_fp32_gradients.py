"""The fp32 coca_ViT-L-14 step's gradients (seeded weights, batch 8, TF32
off) through the fused kernels, plain attention and the kernels' plain
versions, per tensor: cosines, norms and absolute differences, the 40
lowest cosines first. Shows which tensors' gradients are cancellation
(far below the whole gradient's norm), where two correct fp32 routes differ
by rounding.

    python3 scripts/coca_fp32_gradients.py    # on the card; about 1.5 min
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as c  # noqa: E402
from refining_clip_via_dinov2_representations_torch.models import (  # noqa: E402
    create_model, get_tokenizer,
)
from refining_clip_via_dinov2_representations_torch.train.step import StepCfg  # noqa: E402

c.phase_device()
c.phase_build()
model, _ = create_model(c.COCA_MODEL, device="cuda", seed=c.SEED + 40)
model.train()
batch = c._coca_batch(get_tokenizer(c.COCA_MODEL), c.COCA_FP32_BATCH, seed=c.SEED + 51)
cfg = StepCfg(loss_type="coca")
c._set_attn_impl(model, "auto")
lk, gk, _ = c._model_loss_and_grads(model, batch, cfg)
c._set_attn_impl(model, "xla")
lp, gp, _ = c._model_loss_and_grads(model, batch, cfg)
c._set_attn_impl(model, "auto")
with c._plain_versions():
    lf, gf, _ = c._model_loss_and_grads(model, batch, cfg)
cos_k, tog_k = c._grad_cosines(gk, gp)
cos_f, tog_f = c._grad_cosines(gf, gp)
total = sum(float(g.double().norm() ** 2) for g in gp.values()) ** 0.5
print(f"losses kernel {lk:.8f} plain {lp:.8f} plain-versions {lf:.8f}; together {tog_k:.8f} floor {tog_f:.8f}; total grad norm {total:.4e}")
rows = []
for n in gp:
    gn = float(gp[n].double().norm())
    dk = float((gk[n].double() - gp[n].double()).norm())
    df = float((gf[n].double() - gp[n].double()).norm())
    rows.append((cos_k[n], n, gn, dk, df, cos_f[n]))
rows.sort()
for r in rows[:40]:
    print(f"{r[1]}: cos kernel {r[0]:.7f}, floor {r[5]:.7f}; |g| {r[2]:.3e}, |kernel-plain| {r[3]:.3e}, |plainver-plain| {r[4]:.3e}")
big = [r for r in rows if r[2] > 1e-3 * total]
print("min cos over tensors with |g| > 1e-3 total:", min(big)[0] if big else None, len(big), len(rows))
