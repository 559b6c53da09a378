"""chip_smoke.py's device-preprocessing and EVA02 pieces alone, for a short
card run after a change to them: the fused kernels at EVA02's shapes
(``EVA02_CASES``: EVA02-L-14's vision at batches 8 and 32, EVA02-E-14's
head dim 112; ``EVA02_BWD_CASES``) against their plain versions and their
times; then on mini-Flickr at its full 160 + 40 images the train-eval-cli
phase (the host-path baseline), the ``preprocess`` phase (9b) and the zoo
phase's part (e) (``chip_smoke.run_subset``); last, where the image tower's
time goes at buckets 1 and 8 for EVA02-L-14 and for ViT-L-14, a standard
tower of its size (fp32, seeded weights, five calls each under
``torch.profiler``: latency, device busy time, idle share, device
operations per call, the top host operators; ``scripts/profile_torch_serving.py``'s
``profile_calls``).

    python3 scripts/chip_preprocess_eva02_phase.py        # on the card
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as c  # noqa: E402


def phases(work, _cut):
    import time

    import torch

    c.EVAL_TRAIN_IMAGES, c.EVAL_VAL_IMAGES = 160, 40
    d = c.phase_data(os.path.join(work, "full"))
    out, t0 = {}, time.perf_counter()
    eval_cli = c.phase_train_eval_cli(d, work)
    out["train_eval_cli_s"] = time.perf_counter() - t0
    out["preprocess"] = c.phase_preprocess(d, work, eval_cli)
    total = {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    def cosine(a, b):
        return float(torch.nn.functional.cosine_similarity(
            torch.as_tensor(a).double().flatten(1), torch.as_tensor(b).double().flatten(1),
            dim=-1).min())

    out["eva02"] = c.phase_zoo_eva02(add, cosine)
    out["eva02_launches"] = total
    out["tower_profiles"] = tower_profiles()
    return out


def tower_profiles():
    import numpy as np
    import torch

    from refining_clip_via_dinov2_representations_torch.models import create_model
    from scripts.profile_torch_serving import profile_calls

    cells = {}
    for name in (c.EVA02_MODEL, "ViT-L-14"):
        model, _ = create_model(name, device=c.DEVICE, seed=c.SEED + 85)
        for b in c.EVA02_BUCKETS:
            x = torch.from_numpy(np.random.default_rng(c.SEED + 86).normal(
                size=(b, 224, 224, 3)).astype(np.float32)).to(c.DEVICE)

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


c.run_subset(("EVA02_CASES", "EVA02_BWD_CASES"), phases)
