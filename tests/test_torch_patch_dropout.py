"""Patch dropout against the JAX package's ``PatchDropout``.

* The index step: the scores the JAX module drew (recorded from its
  ``jax.random.uniform`` call) fed to ``patch_dropout_keep`` give its output
  exactly, at several probabilities, with and without the CLS token.
* The tower: a CLIP whose vision config sets ``patch_dropout`` 0.5, in
  training with the JAX rng and the port's generator, on the same keep set
  (the port's draw replaced by the JAX scores): image features within 1e-5
  (fp32, the model tests' tolerance), 3 of 5 vision tokens kept.
* Eval mode, and a forward without a generator, keep every token.
* The train step: each step draws from the state's generator (two states
  seeded alike draw alike), and both phases of ``accumulate_grads`` see the
  same kept tokens for the same microbatch.
"""

import numpy as np
import pytest
import torch

from refining_clip_via_dinov2_representations_torch.models import layers
from refining_clip_via_dinov2_representations_torch.models.layers import (
    PatchDropout,
    patch_dropout_keep,
)
from .torch_port_utils import TINY_CFG, images, jax_clip, port_clip, token_ids

PD_CFG = {**TINY_CFG, "vision_cfg": {**TINY_CFG["vision_cfg"], "patch_dropout": 0.5}}
FEATURE_TOL = 1e-5


@pytest.fixture
def jax_scores(monkeypatch):
    """Records every ``jax.random.uniform`` draw (the JAX module's scores)."""
    import jax

    drawn = []
    real = jax.random.uniform

    def uniform(*args, **kwargs):
        out = real(*args, **kwargs)
        drawn.append(np.asarray(out))
        return out

    monkeypatch.setattr(jax.random, "uniform", uniform)
    return drawn


@pytest.mark.parametrize("prob,exclude", [(0.5, True), (0.25, True), (0.9, True),
                                          (0.5, False), (0.99, True)])
def test_the_jax_scores_give_the_jax_tokens(jax_scores, prob, exclude):
    import jax

    from refining_clip_via_dinov2_representations_tpu.models.layers import (
        PatchDropout as JaxPatchDropout,
    )

    x = np.random.default_rng(0).normal(size=(3, 17, 8)).astype(np.float32)
    want = JaxPatchDropout(prob=prob, exclude_first_token=exclude).apply(
        {}, x, deterministic=False, rngs={"patch_dropout": jax.random.PRNGKey(7)})
    (scores,) = jax_scores
    got = patch_dropout_keep(torch.from_numpy(x), torch.tensor(scores), prob, exclude)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    n = 16 if exclude else 17
    assert got.shape[1] == max(1, int(n * (1 - prob))) + (1 if exclude else 0)


def test_the_tower_in_training_on_the_jax_keep_set(jax_scores, monkeypatch):
    import jax

    jmodel, variables = jax_clip(PD_CFG)
    size, ctx = PD_CFG["vision_cfg"]["image_size"], PD_CFG["text_cfg"]["context_length"]
    img, ids = images(4, size), token_ids(4, ctx)
    key = jax.random.PRNGKey(3)
    want = jmodel.apply(variables, img, ids, deterministic=False,
                        rngs={"patch_dropout": key, "dropout": key})
    (scores,) = jax_scores

    model = port_clip(PD_CFG, variables["params"]).train()
    seen = []
    real_keep = layers.patch_dropout_keep

    def keep(x, s, prob, exclude):
        out = real_keep(x, s, prob, exclude)
        seen.append((x.shape[1], out.shape[1]))
        return out

    monkeypatch.setattr(PatchDropout, "scores",
                        staticmethod(lambda b, n, g, device: torch.tensor(scores)))
    monkeypatch.setattr(layers, "patch_dropout_keep", keep)
    with torch.no_grad():
        got = model(torch.from_numpy(img), torch.from_numpy(ids).long(),
                    patch_dropout_generator=torch.Generator())
    assert seen == [(5, 3)]  # 4 patches + CLS -> 2 patches + CLS
    for k in ("image_features", "text_features"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=FEATURE_TOL, rtol=0)
    # the JAX eval forward keeps every token, and so does the port's
    want_eval = jmodel.apply(variables, img, ids)
    with torch.no_grad():
        got_eval = model.eval()(torch.from_numpy(img), torch.from_numpy(ids).long(),
                                patch_dropout_generator=torch.Generator())
    assert len(seen) == 1
    np.testing.assert_allclose(got_eval["image_features"].numpy(),
                               np.asarray(want_eval["image_features"]), atol=FEATURE_TOL, rtol=0)


def test_eval_mode_and_no_generator_are_the_identity():
    pd = PatchDropout(0.5)
    x = torch.randn(2, 9, 4)
    assert pd.train()(x) is x  # training, but no generator: no draw
    assert pd.eval()(x, torch.Generator()) is x
    assert PatchDropout(0.0).train()(x, torch.Generator()) is x
    kept = pd.train()(x, torch.Generator().manual_seed(0))
    assert kept.shape == (2, 5, 4) and torch.equal(kept[:, 0], x[:, 0])
    again = pd(x, torch.Generator().manual_seed(0))
    assert torch.equal(kept, again)  # the same generator state draws alike


def _step_setup(accum_freq: int = 1):
    from refining_clip_via_dinov2_representations_torch.losses import (
        DinoLossCfg,
        DinoProjectionHead,
    )
    from refining_clip_via_dinov2_representations_torch.models import build_model, parse_model_cfg
    from refining_clip_via_dinov2_representations_torch.train import optim, scheduler
    from refining_clip_via_dinov2_representations_torch.train.step import (
        StepCfg,
        TrainState,
        make_train_step,
        train_parameters,
    )

    model = build_model(parse_model_cfg(PD_CFG), seed=1).train()
    torch.manual_seed(1)
    head = DinoProjectionHead(PD_CFG["embed_dim"], 24)
    opt, _ = optim.build_optimizer(train_parameters(model, head), optim.OptimCfg(lr=1e-3),
                                   scheduler.const_lr(1e-3, 0, 4))
    state = TrainState(model, head, opt, 0, torch.Generator().manual_seed(11))
    cfg = StepCfg(loss_type="dino", dino=DinoLossCfg(lambda_soft=0.5), accum_freq=accum_freq,
                  use_patch_dropout=True)
    return state, make_train_step(model, cfg, head)


def _batch(n, lead=()):
    size, ctx = PD_CFG["vision_cfg"]["image_size"], PD_CFG["text_cfg"]["context_length"]
    b = {"images": torch.from_numpy(images(n, size)),
         "texts": torch.from_numpy(token_ids(n, ctx)).long(),
         "dino_features": torch.from_numpy(
             np.random.default_rng(4).normal(size=(n, 24)).astype(np.float32))}
    return {k: v.reshape(*lead, -1, *v.shape[1:]) for k, v in b.items()} if lead else b


def _recording(monkeypatch):
    seen = []
    real_keep = layers.patch_dropout_keep

    def keep(x, scores, prob, exclude):
        seen.append(torch.argsort(scores, dim=-1, stable=True))
        return real_keep(x, scores, prob, exclude)

    monkeypatch.setattr(layers, "patch_dropout_keep", keep)
    return seen


def test_the_step_draws_from_the_state_generator(monkeypatch):
    seen = _recording(monkeypatch)
    runs = []
    for _ in range(2):
        state, step = _step_setup()
        for _ in range(2):
            state, m = step(state, _batch(4))
            assert np.isfinite(float(m["total_loss"]))
        runs.append([float(p.detach().double().sum()) for p in state.model.parameters()])
    assert len(seen) == 4
    assert torch.equal(seen[0], seen[2]) and torch.equal(seen[1], seen[3])  # seeded alike
    assert not torch.equal(seen[0], seen[1])  # a new draw each step
    assert runs[0] == runs[1]


def test_both_accumulation_phases_see_the_same_tokens(monkeypatch):
    seen = _recording(monkeypatch)
    state, step = _step_setup(accum_freq=2)
    state, m = step(state, _batch(8, lead=(2,)))
    assert np.isfinite(float(m["total_loss"]))
    # phase 1 encodes microbatches 0, 1 under no_grad; phase 2 again with grad
    assert len(seen) == 4
    assert torch.equal(seen[0], seen[2]) and torch.equal(seen[1], seen[3])
    assert not torch.equal(seen[0], seen[1])  # the index is folded in
