"""``--device-preprocess`` in the port's train step and CLI.

* The port's step with ``device_preprocess`` against the JAX
  ``make_train_step``'s on the same uint8 batch (a tiny CLIP with the DINO
  head, fp32): the port's box sampler is patched to return the boxes that
  the JAX step draws from its ``crop_rng`` (``tpu/train/step.py:254``), and
  the loss, the metrics and every gradient agree at 1e-5.
* Under accumulation each microbatch is cropped once: both phases, the
  towers and the live DINOv2 teacher see the same pixels, and different
  microbatches different crops.
* A data rank's rows take the boxes the one process gives those rows.
* The CLI with ``--device-preprocess`` on synthetic and on CSV JPEG data:
  the loader ships uint8 at the raw size, the step trains on it.
"""

import os

import numpy as np
import pytest
import torch

from refining_clip_via_dinov2_representations_torch.losses import (
    DinoLossCfg,
    DinoProjectionHead,
)
from refining_clip_via_dinov2_representations_torch.models import (
    build_model,
    parse_model_cfg,
    register_model_config,
)
from refining_clip_via_dinov2_representations_torch.models.convert import (
    jax_head_params_to_state_dict,
    jax_params_to_state_dict,
)
from refining_clip_via_dinov2_representations_torch.ops import preprocess
from refining_clip_via_dinov2_representations_torch.train import optim, scheduler
from refining_clip_via_dinov2_representations_torch.train import step as step_mod
from refining_clip_via_dinov2_representations_torch.train.step import (
    StepCfg,
    TrainState,
    device_preprocess_images,
    make_train_step,
    train_parameters,
)

from .test_torch_preprocess import jax_boxes
from .torch_port_utils import TINY_CFG, jax_clip, token_ids

B, RAW, DINO_DIM = 6, 24, 24
SIZE = TINY_CFG["vision_cfg"]["image_size"]
MEAN, STD = (0.48145466, 0.4578275, 0.40821073), (0.26862954, 0.26130258, 0.27577711)
DP = (SIZE, SIZE, MEAN, STD)
MODEL = "tiny-torch-device-preprocess"
register_model_config(MODEL, TINY_CFG)


def _uint8(n=B, seed=3):
    return np.random.default_rng(seed).integers(0, 256, (n, RAW, RAW, 3), dtype=np.uint8)


def test_step_on_uint8_matches_jax_make_train_step(monkeypatch):
    import jax
    import jax.numpy as jnp

    from refining_clip_via_dinov2_representations_tpu.losses import DinoLossCfg as JaxLossCfg
    from refining_clip_via_dinov2_representations_tpu.losses.dino import (
        DinoProjectionHead as JaxHead,
    )
    from refining_clip_via_dinov2_representations_tpu.models import (
        build_model as jax_build_model, parse_model_cfg as jax_parse,
    )
    from refining_clip_via_dinov2_representations_tpu.train.step import (
        StepCfg as JaxStepCfg, make_loss_fn as jax_make_loss_fn,
    )

    loss_kw = dict(lambda_soft=0.5, soft_mode="kl_teacher", lambda_weighted=0.3)
    _, variables = jax_clip(TINY_CFG)
    jmodel = jax_build_model(jax_parse(TINY_CFG), attn_impl="xla")
    head_params = jax.device_get(JaxHead(dino_dim=DINO_DIM).init(
        jax.random.PRNGKey(1), jnp.zeros((1, TINY_CFG["embed_dim"])))["params"])
    params = {"model": variables["params"], "dino_head": head_params}
    jloss = jax_make_loss_fn(jmodel, JaxStepCfg(loss_type="dino", dino=JaxLossCfg(**loss_kw),
                                                device_preprocess=DP),
                             head=JaxHead(dino_dim=DINO_DIM))
    u8 = _uint8()
    batch = {"images": u8, "texts": token_ids(B, TINY_CFG["text_cfg"]["context_length"], 4),
             "dino_features": np.random.default_rng(5).normal(
                 size=(B, DINO_DIM)).astype(np.float32)}
    # the JAX train step's rngs: state.rng -> step_rng -> crop_rng
    _, step_rng = jax.random.split(jax.random.PRNGKey(0))
    _, crop_rng = jax.random.split(step_rng)
    (jtotal, (jm, _)), jgrads = jax.value_and_grad(jloss, has_aux=True)(
        params, {k: jnp.asarray(v) for k, v in batch.items()}, jnp.asarray(0), step_rng)

    boxes = jax_boxes(crop_rng, B, RAW, RAW)
    drawn = []

    def jax_sampler(generator, n, h, w, *args, **kwargs):
        drawn.append((n, h, w))
        return boxes

    monkeypatch.setattr(preprocess, "sample_crop_boxes", jax_sampler)
    model = build_model(parse_model_cfg(TINY_CFG), attn_impl="fused")
    model.load_state_dict(jax_params_to_state_dict(variables["params"]), strict=True)
    head = DinoProjectionHead(TINY_CFG["embed_dim"], DINO_DIM)
    head.load_state_dict(jax_head_params_to_state_dict(head_params), strict=True)
    named = train_parameters(model, head)
    opt, _ = optim.build_optimizer(named, optim.OptimCfg(lr=1e-3),
                                   scheduler.const_lr(1e-3, 0, 1))
    state = TrainState(model, head, opt, 0, torch.Generator().manual_seed(0))
    step = make_train_step(model, StepCfg(loss_type="dino", dino=DinoLossCfg(**loss_kw),
                                          device_preprocess=DP), head)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    tbatch["texts"] = tbatch["texts"].long()
    assert tbatch["images"].dtype == torch.uint8
    _, m = step(state, tbatch)
    assert drawn == [(B, RAW, RAW)]
    np.testing.assert_allclose(float(m["total_loss"]), float(jtotal), rtol=1e-5)
    for k in ("total_loss", "classic_loss", "soft_loss", "weighted_loss", "logit_scale"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    want = jax_params_to_state_dict(jax.device_get(jgrads["model"]))
    want.update({optim.HEAD_PREFIX + k: v for k, v in
                 jax_head_params_to_state_dict(jax.device_get(jgrads["dino_head"])).items()})
    scale = max(float(v.abs().max()) for v in want.values())
    for n, p in named.items():
        np.testing.assert_allclose(p.grad.numpy(), want[n].reshape(p.shape).numpy(),
                                   atol=1e-5 * scale, rtol=0, err_msg=n)


class _Recorder:
    """Wraps a module's forward (or a teacher's ``extract``) and keeps the
    images it was given."""

    def __init__(self):
        self.seen = []

    def wrap(self, fn):
        def inner(images, *args, **kwargs):
            self.seen.append(images.detach().clone())
            return fn(images, *args, **kwargs)

        return inner


def test_accumulation_and_the_live_teacher_see_the_students_pixels():
    from .torch_port_utils import DINO_TINY, jax_dinov2, port_dinov2
    from refining_clip_via_dinov2_representations_torch.train.dino_teacher import (
        LiveDinoTeacher,
    )

    accum = 2
    model = build_model(parse_model_cfg(TINY_CFG), attn_impl="fused")
    _, dparams = jax_dinov2()
    teacher = LiveDinoTeacher(port_dinov2(dparams), input_mean=MEAN, input_std=STD)
    head = DinoProjectionHead(TINY_CFG["embed_dim"], DINO_TINY["hidden_size"])
    named = train_parameters(model, head)
    opt, _ = optim.build_optimizer(named, optim.OptimCfg(lr=1e-3),
                                   scheduler.const_lr(1e-3, 0, 1))
    state = TrainState(model, head, opt, 0, torch.Generator().manual_seed(0))
    student, teacher_seen = _Recorder(), _Recorder()
    model.encode_image = student.wrap(model.encode_image)
    teacher.extract = teacher_seen.wrap(teacher.extract)
    cfg = StepCfg(loss_type="dino", dino=DinoLossCfg(lambda_soft=0.5, soft_mode="kl_teacher"),
                  accum_freq=accum, device_preprocess=DP)
    step = make_train_step(model, cfg, head, dino_teacher=teacher)
    u8 = torch.from_numpy(np.stack([_uint8(4, 1), _uint8(4, 2)]))
    texts = torch.from_numpy(token_ids(8, TINY_CFG["text_cfg"]["context_length"], 3)).long()
    _, metrics = step(state, {"images": u8, "texts": texts.view(accum, 4, -1)})
    assert torch.isfinite(metrics["total_loss"])
    # phase 1 encodes microbatches 0 and 1, phase 2 both again
    assert len(student.seen) == 4 and len(teacher_seen.seen) == 2
    for j in range(accum):
        cached, live = student.seen[j], student.seen[accum + j]
        assert cached.shape == (4, SIZE, SIZE, 3) and cached.dtype == torch.float32
        assert torch.equal(cached, live)
        assert torch.equal(teacher_seen.seen[j], cached)
    assert not torch.allclose(student.seen[0], student.seen[1])
    # the same uint8 rows in both microbatches still take different crops
    seed_state = torch.Generator().manual_seed(0)
    crop_seed = int(torch.randint(0, 1 << 62, (1,), generator=seed_state))
    same = device_preprocess_images(cfg, torch.stack([u8[0], u8[0]]), crop_seed)
    assert torch.equal(same[0], student.seen[0])
    assert not torch.allclose(same[0], same[1])


@pytest.mark.parametrize("accum", [1, 2])
def test_a_data_ranks_rows_take_the_one_process_boxes(accum):
    cfg = StepCfg(accum_freq=accum, device_preprocess=DP)
    world, per_rank = 2, 3
    full = torch.from_numpy(np.stack([_uint8(world * per_rank, 10 + j) for j in range(accum)]))
    if accum == 1:
        full = full[0]
    whole = device_preprocess_images(cfg, full, seed=123)
    for rank in range(world):
        rows = slice(rank * per_rank, (rank + 1) * per_rank)
        mine = device_preprocess_images(cfg, full[..., rows, :, :, :], seed=123, rank=rank,
                                        world=world)
        torch.testing.assert_close(mine, whole[..., rows, :, :, :], rtol=0, atol=1e-6)


def _record_step_batches(monkeypatch):
    """Wraps ``make_train_step`` so that the CLI's steps record their batch
    images' dtype and shape."""
    seen = []
    real = step_mod.make_train_step

    def make(*args, **kwargs):
        inner = real(*args, **kwargs)

        def recorded(state, batch):
            seen.append((batch["images"].dtype, tuple(batch["images"].shape)))
            return inner(state, batch)

        return recorded

    monkeypatch.setattr(step_mod, "make_train_step", make)
    return seen


def test_cli_on_synthetic_data_ships_uint8_at_the_raw_size(tmp_path, monkeypatch):
    from refining_clip_via_dinov2_representations_torch.train.main import main

    seen = _record_step_batches(monkeypatch)
    records = main(["--model", MODEL, "--dataset-type", "synthetic", "--train-num-samples",
                    "16", "--batch-size", "4", "--epochs", "1", "--workers", "2", "--logs",
                    str(tmp_path), "--name", "run", "--precision", "fp32", "--force-cpu",
                    "--device-preprocess", "--device-preprocess-raw-size", str(RAW),
                    "--accum-freq", "2"])
    assert seen == [(torch.uint8, (2, 4, RAW, RAW, 3))] * 2
    assert records and all(np.isfinite(r["total_loss"]) for r in records if "total_loss" in r)
    assert "device preprocess: host ships uint8" in (tmp_path / "run" / "out.log").read_text()


def test_cli_on_csv_jpegs_decodes_natively_and_trains(tmp_path, monkeypatch):
    from PIL import Image

    from refining_clip_via_dinov2_representations_torch import native
    from refining_clip_via_dinov2_representations_torch.train.main import main

    rng = np.random.default_rng(0)
    rows = []
    for i in range(8):
        path = tmp_path / f"img_{i}.jpg"
        Image.fromarray(rng.integers(0, 256, (40 + i, 52, 3), dtype=np.uint8)).save(path)
        rows.append(f"{path},a photo number {i},0")
    for split in ("train", "val"):
        (tmp_path / f"{split}.csv").write_text("filepath,title,label\n" + "\n".join(rows) + "\n")
    decoded = []
    real = native.decode_jpeg
    monkeypatch.setattr(native, "decode_jpeg",
                        lambda data, target=0: decoded.append(target) or real(data, target))
    seen = _record_step_batches(monkeypatch)
    main(["--model", MODEL, "--train-data", str(tmp_path / "train.csv"), "--val-data",
          str(tmp_path / "val.csv"), "--dataset-type", "csv", "--batch-size", "4", "--epochs",
          "1", "--workers", "2", "--logs", str(tmp_path), "--name", "run", "--precision",
          "fp32", "--force-cpu", "--device-preprocess", "--device-preprocess-raw-size",
          str(RAW)])
    assert seen == [(torch.uint8, (4, RAW, RAW, 3))] * 2
    assert decoded.count(RAW) == 8  # the train rows, through the native path (or PIL)
    assert os.path.exists(tmp_path / "run" / "checkpoints" / "epoch_1.pt")
