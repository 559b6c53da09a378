"""The last transformer towers under the model axis, on two gloo ranks:
EVA02 with sub-LN, SwiGLU and rope, EVA02 with E's post-norm blocks, the
relative-position ViT, Swin and ViTamin, each tiny.

The test process draws each JAX tower's weights with numpy (on
``jax.eval_shape``'s shapes), takes one fp32 step of the JAX tower (the sum
of its pooled features times a seeded cotangent, ``jax.value_and_grad``)
and carries the weights into the port (``models/convert.py``'s emitters).
Each rank runs the port tower whole (the one-process step, which is held to
JAX: loss 1e-5 relative, every gradient at cosine >= 0.9999), then split
over the model group of the two ranks (``parallel/tensor.py:
shard_module``): the loss at 1e-5 relative and every gradient, the split
ones gathered whole, at cosine >= 0.9999 against the one-process step, the
relative-position tables' and the sub-LN and SwiGLU norms' whole gradients
among them; then one AdamW step of the split tower, after which every
parameter that stays whole (the tables and the norms included) is equal on
the two ranks. The same ranks serve a tiny EVA02 CLIP (SwiGLU, sub-LN,
rope) through the engine on a ``(1, 2)`` mesh against the one-process
engine (1e-5), and train it through ``train.main`` at ``--mesh-model-axis
2``: the per-step losses equal the one-process CLI's (1e-5 relative).
``split_forward_worker`` serves ``test_torch_eva02.py`` and
``test_torch_vit_variants.py``: a seeded tower split over two ranks gives
the whole tower's forward.
"""

import numpy as np
import pytest

from refining_clip_via_dinov2_representations_torch.models import eva02 as teva02
from refining_clip_via_dinov2_representations_torch.models import register_model_config

from .torch_dist_utils import run_ranks

W, B, OUT = 2, 2, 24
EVA02_FORMS = {
    "eva02-swiglu": dict(width=32, layers=2, heads=4, mlp_hidden=40, patch_size=8,
                         image_size=24, ref_feat_shape=(2, 2)),
    "eva02-post-norm": dict(width=32, layers=2, heads=4, mlp_hidden=48, patch_size=8,
                            image_size=24, swiglu=False, rope=False, subln=False,
                            post_norm=True, ref_feat_shape=None),
}
RELPOS = dict(width=32, layers=2, heads=4, patch_size=8, image_size=16)
SWIN = dict(image_size=32, patch_size=4, embed_dim=16, depths=(2, 2), num_heads=(2, 4),
            window_size=4)
VITAMIN = dict(stem_width=8, conv_dims=(8, 16), conv_depths=(1, 1), embed_dim=32, depth=2,
               heads=2, image_size=64)
CASES = tuple(EVA02_FORMS) + ("relpos", "swin", "vitamin")
# a tiny EVA02 CLIP for the engine and the CLI (registered in every process
# that imports this module, the spawned ranks included)
CLI_MODEL, CLI_TRUNK = "tiny-torch-tp-eva02", "eva02_tiny_tp_cli"
teva02.EVA02_DIMS[CLI_TRUNK] = teva02.Eva02Cfg(**EVA02_FORMS["eva02-swiglu"])
register_model_config(CLI_MODEL, {
    "custom_text": True, "embed_dim": OUT,
    "vision_cfg": {"image_size": 24, "timm_model_name": CLI_TRUNK, "timm_model_pretrained": False,
                   "timm_pool": "token", "timm_proj": None},
    "text_cfg": {"context_length": 12, "vocab_size": 49408, "width": 32, "heads": 4,
                 "layers": 1}})
SIZE = {"eva02-swiglu": 24, "eva02-post-norm": 24, "relpos": 16, "swin": 32, "vitamin": 64}
# the whole parameters that a split tower uses on a rank's part
HELPERS = {"eva02-swiglu": ("attn.norm.weight", "attn.norm.bias", "mlp.norm.weight",
                            "mlp.norm.bias"),
           "eva02-post-norm": (), "relpos": ("relative_position_bias_table",),
           "swin": ("attn.relative_position_bias_table",), "vitamin": ()}


def port_tower(case: str):
    """The port's tiny tower of ``case`` (no JAX)."""
    from refining_clip_via_dinov2_representations_torch.models import (
        eva02, relpos_vit, swin, vitamin,
    )

    if case in EVA02_FORMS:
        return eva02.Eva02VisionTower(eva02.Eva02Cfg(**EVA02_FORMS[case]), OUT, attn_impl="xla")
    if case == "relpos":
        return relpos_vit.RelPosVisionTower(output_dim=OUT, attn_impl="xla", **RELPOS)
    if case == "swin":
        return swin.SwinVisionTower(swin.SwinCfg(**SWIN), OUT, attn_impl="xla")
    return vitamin.ViTaminVisionTower(vitamin.ViTaminCfg(**VITAMIN), OUT, attn_impl="xla")


def _jax_tower(case: str):
    from refining_clip_via_dinov2_representations_tpu.models import (
        eva02, relpos_vit, swin, vitamin,
    )

    if case in EVA02_FORMS:
        return eva02.Eva02VisionTower(cfg=eva02.Eva02Cfg(**EVA02_FORMS[case]), output_dim=OUT)
    if case == "relpos":
        return relpos_vit.RelPosVisionTower(output_dim=OUT, **RELPOS)
    if case == "swin":
        return swin.SwinVisionTower(cfg=swin.SwinCfg(**SWIN), output_dim=OUT)
    return vitamin.ViTaminVisionTower(cfg=vitamin.ViTaminCfg(**VITAMIN), output_dim=OUT)


def _to_port(case: str, tree) -> dict:
    """A JAX tower tree -> the port tower's state dict (numpy)."""
    from refining_clip_via_dinov2_representations_torch.models import convert

    sd = {}
    emit = {"relpos": convert._emit_relpos, "swin": convert._emit_swin,
            "vitamin": convert._emit_vitamin}.get(case, convert._emit_eva02)
    emit(sd, tree)
    return {k[len("visual."):]: v.numpy() for k, v in sd.items()}


def _jax_case(case: str, seed: int):
    """(state dict, images, cotangent, the JAX step) of ``case``:
    numpy-drawn weights (N(0, 0.05) vectors, norm scales about 1, kernels
    N(0, fan_in^-1/2)); the step returns the JAX loss and gradients (as a
    port state dict) when called."""
    import jax
    import jax.numpy as jnp

    tower = _jax_tower(case)
    x = np.random.default_rng(seed).normal(size=(B, SIZE[case], SIZE[case], 3)).astype(np.float32)
    shapes = jax.eval_shape(tower.init, jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    rng = np.random.default_rng(seed + 1)

    def draw(path, leaf):
        std = 0.05 if len(leaf.shape) < 2 else float(np.prod(leaf.shape[:-1])) ** -0.5
        v = rng.normal(0.0, std, leaf.shape).astype(np.float32)
        return v + 1.0 if jax.tree_util.keystr(path).endswith("['scale']") else v

    params = jax.tree_util.tree_map_with_path(draw, dict(shapes))
    cot = np.random.default_rng(seed + 2).normal(size=(B, OUT)).astype(np.float32)

    def step():
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: jnp.sum(tower.apply({"params": p}, x) * cot)))(params)
        return float(loss), _to_port(case, jax.device_get(grads))

    return _to_port(case, params), x, cot, step


def _cosine(a, b) -> float:
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(a @ b / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-300))


def _cli_argv(logs: str, name: str) -> list:
    return ["--model", CLI_MODEL, "--dataset-type", "synthetic", "--train-num-samples", "16",
            "--batch-size", "4", "--epochs", "1", "--force-cpu", "--precision", "fp32",
            "--workers", "1", "--logs", logs, "--name", name, "--log-every-n-steps", "1",
            "--use_dino_general", "--lambda_soft", "0.5", "--soft_mode", "kl_teacher",
            "--lr", "1e-3", "--eps", "1e-3"]


def _engine_case(mesh) -> dict:
    """Rank 0: the largest difference of the split engine's features from
    the one-process engine's; the other rank follows."""
    import torch

    from refining_clip_via_dinov2_representations_torch.inference import ClipInferenceEngine
    from refining_clip_via_dinov2_representations_torch.models import (
        build_model, get_model_config, parse_model_cfg,
    )

    from .torch_port_utils import images, token_ids

    one, eng = (ClipInferenceEngine(build_model(parse_model_cfg(get_model_config(CLI_MODEL)),
                                                attn_impl="xla", seed=9),
                                    (24, 24), 12, buckets=(1, 4), dtype=torch.float32, mesh=m)
                for m in (None, mesh))
    out = {"n_split": len(eng.model.tp_splits)}
    if not eng.leader:
        eng.follow()
        return out
    x, ids = images(3, 24, seed=3), token_ids(3, 12, seed=4)
    out["image"] = float(np.abs(eng.encode_image(x) - one.encode_image(x)).max())
    out["text"] = float(np.abs(eng.encode_text(ids) - one.encode_text(ids)).max())
    eng.stop()
    return out


def _step_worker(rank, world, inputs, logs):
    """Each case's one-process and split steps on this rank, and the whole
    parameters after one AdamW step of the split tower; then the engine and
    the CLI of the tiny EVA02 CLIP on a ``(1, 2)`` mesh."""
    import copy

    import torch

    from refining_clip_via_dinov2_representations_torch.parallel.mesh import create_mesh
    from refining_clip_via_dinov2_representations_torch.parallel.tensor import (
        gather_tensor, model_parallel, shard_module,
    )
    from refining_clip_via_dinov2_representations_torch.train.distributed import model_group

    create_mesh(model=world, device_type="cpu")
    mp = model_parallel(model_group())
    out = {}
    for case, (sd, x, cot) in inputs.items():
        whole = port_tower(case)
        whole.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
        x, cot = torch.from_numpy(x), torch.from_numpy(cot)

        def step(tower):
            loss = (tower(x) * cot).sum()
            loss.backward()
            return float(loss), {n: p.grad for n, p in tower.named_parameters()}

        split = copy.deepcopy(whole)
        loss_one, grads_one = step(whole)
        splits = shard_module(split, mp)
        loss_split, grads = step(split)
        grads = {n: (gather_tensor(g, splits[n], mp) if n in splits else g).numpy()
                 for n, g in grads.items()}
        opt = torch.optim.AdamW(split.parameters(), lr=1e-2)
        opt.step()
        kept = {n: p.detach().numpy().copy() for n, p in split.named_parameters()
                if n not in splits}
        out[case] = {"loss_one": loss_one, "grads_one": {n: g.numpy() for n, g in
                                                         grads_one.items()},
                     "loss_split": loss_split, "grads_split": grads, "n_split": len(splits),
                     "kept": kept}
    out["engine"] = _engine_case(create_mesh(model=world, device_type="cpu"))
    from refining_clip_via_dinov2_representations_torch.train.main import main

    out["cli"] = main(_cli_argv(logs, "tp") + ["--mesh-model-axis", str(world)])
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import threading

    from refining_clip_via_dinov2_representations_torch.train.main import main

    logs = str(tmp_path_factory.mktemp("tp_towers_cli"))
    drawn = {case: _jax_case(case, seed=10 + i) for i, case in enumerate(CASES)}
    ranks = {}
    # the ranks run while this process takes the JAX steps and the
    # one-process CLI run
    spawn = threading.Thread(target=lambda: ranks.update(
        out=run_ranks(_step_worker, W, {c: v[:3] for c, v in drawn.items()}, logs)))
    spawn.start()
    jax_side = {case: v[3]() for case, v in drawn.items()}
    jax_side["cli"] = main(_cli_argv(logs, "one"))
    spawn.join()
    assert "out" in ranks, "the ranks failed (their traceback is above)"
    return jax_side, ranks["out"]


@pytest.mark.parametrize("case", CASES)
def test_one_process_step_equals_jax(runs, case):
    jax_side, ranks = runs
    jloss, jgrads = jax_side[case]
    r = ranks[0][case]
    np.testing.assert_allclose(r["loss_one"], jloss, rtol=1e-5)
    assert r["grads_one"].keys() == jgrads.keys()
    low = min((_cosine(g, jgrads[n]), n) for n, g in r["grads_one"].items())
    assert low[0] >= 0.9999, low


@pytest.mark.parametrize("case", CASES)
def test_split_step_equals_the_one_process_step(runs, case):
    _, ranks = runs
    for rank, r in enumerate(ranks):
        res = r[case]
        assert res["n_split"] > 0, case
        np.testing.assert_allclose(res["loss_split"], res["loss_one"], rtol=1e-5)
        assert res["grads_split"].keys() == res["grads_one"].keys()
        low = min((_cosine(g, res["grads_one"][n]), n) for n, g in res["grads_split"].items())
        assert low[0] >= 0.9999, (rank, low)
        for end in HELPERS[case]:  # the helpers' whole gradients are held too
            names = [n for n in res["grads_split"] if n.endswith(end)]
            assert names and all(res["grads_split"][n].shape == res["grads_one"][n].shape
                                 for n in names), (case, end)


@pytest.mark.parametrize("case", CASES)
def test_whole_parameters_stay_equal_across_ranks_after_a_step(runs, case):
    _, ranks = runs
    a, b = ranks[0][case]["kept"], ranks[1][case]["kept"]
    assert a.keys() == b.keys()
    for end in HELPERS[case]:
        assert any(n.endswith(end) for n in a), (case, end)
    for n in a:
        np.testing.assert_array_equal(a[n], b[n], err_msg=f"{case} {n}")


def split_forward_worker(rank, world, cases):
    """For each case: (the number of split parameters, the split tower's
    largest difference from the whole tower's pooled features over their
    largest magnitude), on a seeded tower."""
    import copy

    import torch

    from refining_clip_via_dinov2_representations_torch.models.clip import init_weights
    from refining_clip_via_dinov2_representations_torch.parallel.mesh import create_mesh
    from refining_clip_via_dinov2_representations_torch.parallel.tensor import (
        model_parallel, shard_module,
    )
    from refining_clip_via_dinov2_representations_torch.train.distributed import model_group

    create_mesh(model=world, device_type="cpu")
    mp = model_parallel(model_group())
    out = {}
    for case in cases:
        whole = port_tower(case).eval()
        init_weights(whole, seed=5)
        g = torch.Generator().manual_seed(6)
        with torch.no_grad():  # every vector away from its init constant
            for p in whole.parameters():
                if p.dim() == 1:
                    p.add_(torch.randn(p.shape, generator=g) * 0.1)
        split = copy.deepcopy(whole)
        splits = shard_module(split, mp)
        x = torch.randn(B, SIZE[case], SIZE[case], 3, generator=torch.Generator().manual_seed(7))
        with torch.no_grad():
            want, got = whole(x), split(x)
        out[case] = (len(splits), float((got - want).abs().max() / want.abs().max()))
    return out


def split_forward(cases):
    """``split_forward_worker`` on two spawned gloo ranks, rank 0's result."""
    return run_ranks(split_forward_worker, W, tuple(cases))[0]


def test_the_split_engine_serves_eva02_as_one_process(runs):
    _, ranks = runs
    got = ranks[0]["engine"]
    assert got["image"] <= 1e-5 and got["text"] <= 1e-5, got
    assert all(r["engine"]["n_split"] > 0 for r in ranks)


def test_the_cli_trains_eva02_at_model_axis_2_as_one_process(runs):
    jax_side, ranks = runs
    want, (first, second) = jax_side["cli"], (r["cli"] for r in ranks)
    assert first == second and [r["step"] for r in first] == [1, 2, 3, 4]
    for got, ref in zip(first, want):
        for k in ("total_loss", "classic_loss", "soft_loss"):
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, err_msg=f"{got['step']} {k}")
