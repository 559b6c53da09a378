"""Zero-shot classification in the port against the JAX package: the
prompt-ensemble classifier (12 classes, 3 templates, 5 classes a batch so
the last batch is partial, and the one-class legacy variant) within 1e-5,
``accuracy``'s counts, the sample order of ``ImageFolderDataset`` (digit
folders sorted as numbers), and ``zero_shot_eval`` on a tiny digit-named
ImageFolder (equal top-1/top-5) with its frequency gate. The ImageNet
class names and templates are cut to a dozen classes here; the CLI test
runs all 1000 (``tests/test_torch_train_cli.py``)."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from refining_clip_via_dinov2_representations_torch.eval import _imagenet_metadata as meta
from refining_clip_via_dinov2_representations_torch.eval.zero_shot_classifier import (
    build_zero_shot_classifier,
    build_zero_shot_classifier_legacy,
)
from refining_clip_via_dinov2_representations_torch.tokenizer import SimpleTokenizer
from refining_clip_via_dinov2_representations_torch.train import zero_shot
from refining_clip_via_dinov2_representations_torch.train.data import (
    ImageFolderDataset,
    get_data,
)
from refining_clip_via_dinov2_representations_torch.transform import image_transform

from .torch_port_utils import TINY_CFG, jax_clip, port_clip

TOL = 1e-5
CLASSES = ["cat", "dog", "goldfish", "tree frog", "red fox", "school bus", "pizza",
           "daisy", "volcano", "kite (bird of prey)", "tench", "lemon"]
TEMPLATES = ["a photo of a {}.", "a drawing of the {}.", "itap of my {}."]
CTX = TINY_CFG["text_cfg"]["context_length"]
TOK = SimpleTokenizer(context_length=CTX)


def test_metadata_equals_jax():
    from refining_clip_via_dinov2_representations_tpu.eval import _imagenet_metadata as jmeta

    assert meta.IMAGENET_CLASSNAMES == jmeta.IMAGENET_CLASSNAMES
    assert len(meta.IMAGENET_CLASSNAMES) == 1000 and len(meta.OPENAI_IMAGENET_TEMPLATES) == 80
    assert meta.OPENAI_IMAGENET_TEMPLATE_STRINGS == jmeta.OPENAI_IMAGENET_TEMPLATE_STRINGS
    assert meta.SIMPLE_IMAGENET_TEMPLATE_STRINGS == jmeta.SIMPLE_IMAGENET_TEMPLATE_STRINGS
    assert [t("x") for t in meta.OPENAI_IMAGENET_TEMPLATES] == [
        t("x") for t in jmeta.OPENAI_IMAGENET_TEMPLATES]


@pytest.fixture(scope="module")
def models():
    jmodel, variables = jax_clip(TINY_CFG, seed=21)
    return jmodel, variables, port_clip(TINY_CFG, variables["params"])


@pytest.mark.parametrize("per_batch,callables", [(5, False), (5, True), (None, False)],
                         ids=["batches-of-5-strings", "batches-of-5-callables", "one-batch"])
def test_classifier_matches_jax(models, per_batch, callables):
    from refining_clip_via_dinov2_representations_tpu.eval.zero_shot_classifier import (
        build_zero_shot_classifier as jax_build,
    )
    from refining_clip_via_dinov2_representations_tpu.tokenizer import (
        SimpleTokenizer as JaxTokenizer,
    )

    jmodel, variables, model = models
    templates = [(lambda c, t=t: t.format(c)) for t in TEMPLATES] if callables else TEMPLATES
    got = build_zero_shot_classifier(model, TOK, CLASSES, templates,
                                     num_classes_per_batch=per_batch)
    want = np.asarray(jax_build(jmodel, variables, JaxTokenizer(context_length=CTX), CLASSES,
                                templates, num_classes_per_batch=per_batch))
    assert tuple(got.shape) == want.shape == (32, len(CLASSES))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    np.testing.assert_allclose(got.norm(dim=0).numpy(), 1.0, atol=1e-6)
    legacy = build_zero_shot_classifier_legacy(model, TOK, CLASSES, templates)
    np.testing.assert_allclose(legacy.numpy(), want, atol=TOL, rtol=0)


@pytest.mark.parametrize("seed", [0, 1])
def test_accuracy_counts_equal_jax(seed):
    from refining_clip_via_dinov2_representations_tpu.train.zero_shot import (
        accuracy as jax_accuracy,
    )

    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(37, 12)).astype(np.float32)
    target = rng.integers(0, 12, 37)
    assert zero_shot.accuracy(logits, target, topk=(1, 5)) == jax_accuracy(
        logits, target, topk=(1, 5))


def _image_folder(root, names, per_class=2, size=20, seed=0):
    from PIL import Image

    rng = np.random.default_rng(seed)
    for name in names:
        (root / name).mkdir(parents=True)
        for j in range(per_class):
            Image.fromarray(rng.integers(0, 255, (size, size, 3), dtype=np.uint8)).save(
                root / name / f"img{j}.png")
    (root / names[0] / "notes.txt").write_text("not an image")
    return str(root)


@pytest.mark.parametrize("names", [[str(i) for i in range(12)], ["b", "a", "c10", "c9"]],
                         ids=["digits", "names"])
def test_image_folder_order_equals_jax(tmp_path, names):
    from refining_clip_via_dinov2_representations_tpu.train.data import (
        ImageFolderDataset as JaxImageFolder,
    )

    root = _image_folder(tmp_path / "folder", names, per_class=1)
    got, want = ImageFolderDataset(root), JaxImageFolder(root)
    assert got.samples == want.samples and got.class_to_idx == want.class_to_idx
    if names[0] == "0":  # '10' after '9', each folder its own class index
        assert [lbl for _, lbl in got.samples] == list(range(12))
    sample = ImageFolderDataset(root, transform=image_transform(16, False))[0]
    assert sample["images"].shape == (16, 16, 3) and sample["labels"] == got.samples[0][1]


def _args(folder, **kw):
    return SimpleNamespace(imagenet_val=folder, imagenet_v2=folder, batch_size=5, workers=1,
                           zeroshot_frequency=1, epochs=3, model="tiny", train_data=None,
                           dataset_type="auto", val_data=None, **kw)


def test_zero_shot_eval_matches_jax(tmp_path, models, monkeypatch):
    from refining_clip_via_dinov2_representations_tpu.tokenizer import (
        SimpleTokenizer as JaxTokenizer,
    )
    from refining_clip_via_dinov2_representations_tpu.train import data as jax_data
    from refining_clip_via_dinov2_representations_tpu.train import zero_shot as jax_zero_shot

    for mod in (zero_shot, jax_zero_shot):
        monkeypatch.setattr(mod, "IMAGENET_CLASSNAMES", tuple(CLASSES))
        monkeypatch.setattr(mod, "OPENAI_IMAGENET_TEMPLATES", tuple(
            (lambda c, t=t: t.format(c)) for t in TEMPLATES))
    jmodel, variables, model = models
    folder = _image_folder(tmp_path / "v2", [str(i) for i in range(12)], per_class=2)
    transform = image_transform(16, False)
    args = _args(folder)
    data = get_data(args, (transform, transform))
    assert set(data) == {"imagenet-val", "imagenet-v2"}
    assert data["imagenet-val"].dataloader.num_samples == 24
    got = zero_shot.zero_shot_eval(model, data, 0, args, tokenizer=TOK)
    jdata = {k: jax_data.get_imagenet(args, (transform, transform), s)
             for k, s in (("imagenet-val", "val"), ("imagenet-v2", "v2"))}
    want = jax_zero_shot.zero_shot_eval(jmodel, variables, jdata, 0, args,
                                        tokenizer=JaxTokenizer(context_length=CTX))
    assert set(got) == set(want) == {"imagenet-zeroshot-val-top1", "imagenet-zeroshot-val-top5",
                                     "imagenetv2-zeroshot-val-top1",
                                     "imagenetv2-zeroshot-val-top5"}
    assert got == want
    # the frequency gate: epoch 1 of 3 at frequency 2 skips, the last epoch runs
    gated = _args(folder)
    gated.zeroshot_frequency = 2
    assert zero_shot.zero_shot_eval(model, data, 1, gated, TOK) == {}
    assert zero_shot.zero_shot_eval(model, data, 3, gated, TOK) == got
    gated.zeroshot_frequency = 0
    assert zero_shot.zero_shot_eval(model, data, 0, gated, TOK) == {}
    assert zero_shot.zero_shot_eval(model, {}, 0, args, TOK) == {}


def test_imagenet_train_split_is_not_ported(tmp_path):
    from refining_clip_via_dinov2_representations_torch.train.data import get_imagenet

    with pytest.raises(NotImplementedError, match="imagenet-train"):
        get_imagenet(_args(str(tmp_path)), (None, None), "train")


def test_run_scores_the_classifier_on_the_model_device(models, tmp_path):
    """``run`` = ``100 * encode_image(normalize) @ classifier`` per batch."""
    _, _, model = models
    folder = _image_folder(tmp_path / "f", [str(i) for i in range(4)], per_class=3)
    transform = image_transform(16, False)
    loader = get_data(_args(folder), (transform, transform))["imagenet-val"].dataloader
    classifier = build_zero_shot_classifier(model, TOK, CLASSES[:4], TEMPLATES)
    top1, top5 = zero_shot.run(model, classifier, loader)
    feats, labels = [], []
    for b in loader:
        with torch.no_grad():
            feats.append(model.encode_image(torch.from_numpy(b["images"]), normalize=True))
        labels.append(b["labels"])
    logits = (100.0 * torch.cat(feats) @ classifier).numpy()
    target = np.concatenate(labels)
    assert top1 == float((logits.argmax(1) == target).mean()) and top5 == 1.0


@pytest.mark.cuda
def test_cuda_classifier_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from refining_clip_via_dinov2_representations_torch.models import (
        build_model, parse_model_cfg,
    )
    from refining_clip_via_dinov2_representations_torch.ops.fused_attention import (
        fused_attention_fwd,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    model = build_model(parse_model_cfg(TINY_CFG), seed=4).eval()
    card = build_model(parse_model_cfg(TINY_CFG), seed=4).cuda().eval()
    before = fused_attention_fwd.launches
    got = build_zero_shot_classifier(card, TOK, CLASSES, TEMPLATES, num_classes_per_batch=5)
    torch.cuda.synchronize()
    assert fused_attention_fwd.launches == before + 3 * 2  # 3 text calls of 2 layers
    want = build_zero_shot_classifier(model, TOK, CLASSES, TEMPLATES, num_classes_per_batch=5)
    torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=0)
