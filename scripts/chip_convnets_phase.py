"""chip_smoke.py's convolution-tower pieces alone, for a short card run after a
change to them: the fused kernels at the towers' shapes (``CONVNET_CASES``:
the ResNet pool's one query over 50 and 197 keys, convnext_base_w's causal
text; ``CONVNET_BWD_CASES``) against their plain versions and their times;
the ``convnets`` phase (13d: RN50 by its ``openai`` tag, its DINO-soft step,
RN50x64 at 448 px, convnext_base_w by its tag and its checkpointed step,
convnext_large_d's mlp head; ``chip_smoke.run_subset``); last, where the
image tower's time goes at buckets 1 and 8 for RN50 and convnext_base_w
(fp32, seeded weights, five calls each under ``torch.profiler``: latency,
device busy time, idle share, device operations per call, the top host
operators; ``scripts/profile_torch_serving.py``'s ``profile_calls``).

    python3 scripts/chip_convnets_phase.py        # on the card
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as c  # noqa: E402


def phases(work, _cut):
    out = {"convnets": c.phase_convnets(work)}
    out["tower_profiles"] = tower_profiles()
    return out


def tower_profiles():
    import numpy as np
    import torch

    from refining_clip_via_dinov2_representations_torch.models import (
        create_model, get_model_config,
    )
    from scripts.profile_torch_serving import profile_calls

    cells = {}
    for name in (c.RN_MODEL, c.CN_MODEL):
        model, _ = create_model(name, device=c.DEVICE, seed=c.SEED + 85)
        size = get_model_config(name)["vision_cfg"]["image_size"]
        for b in c.CONVNET_BUCKETS:
            x = torch.from_numpy(np.random.default_rng(c.SEED + 86).normal(
                size=(b, size, size, 3)).astype(np.float32)).to(c.DEVICE)

            def call(x):
                with torch.inference_mode():
                    model.encode_image(x)
                torch.cuda.synchronize()

            r = profile_calls(call, x, 5)
            cells[f"{name} image b{b}"] = r
            host = ", ".join(f"{k} {v['self_ms']:.3f} ms x {v['count']:.0f}"
                             for k, v in list(r["top_host_ops"].items())[:4])
            print(f"profile {name} encode_image fp32 b{b}: latency {r['latency_ms']:.3f} ms "
                  f"(under the profiler), device busy {r['device_busy_ms']:.3f} ms, idle "
                  f"{r['idle_share']:.1%}, {r['device_ops_per_call']:.0f} device ops a call; "
                  f"host: {host} [{c.CARD}]", flush=True)
        del model
        torch.cuda.empty_cache()
    return cells


c.run_subset(("CONVNET_CASES", "CONVNET_BWD_CASES"), phases)
