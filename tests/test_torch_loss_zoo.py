"""The rest of the loss zoo in one process, against the JAX package:
``cyclip_loss`` and ``distill_clip_loss``, open_clip's loss classes
(``losses/compat.py``) and ``create_loss``'s dispatch.

Inputs are numpy-seeded unit rows (B = 6, D = 8; the distillation teacher
D = 12) in fp32, and bf16 rows for the fp32 promotion; every loss value and
the gradients with respect to the rows and the logit scale against
``jax.grad`` of the JAX function at 1e-6 relative (the gradients within
1e-6 of their largest magnitude). The classes' return conventions (a dict
under ``output_dict``, else a scalar or a tuple; the DINO class's ``None``)
and their distributed arguments (``world_size`` > 1 without a process group
raises, as the JAX ``_check_dist_args`` without an ``axis_name``;
``use_horovod`` raises) are checked beside the JAX classes'.
"""

import argparse

import numpy as np
import pytest
import torch

from refining_clip_via_dinov2_representations_torch import losses as tl
from refining_clip_via_dinov2_representations_torch.losses import compat as tcompat

B, D, DT = 6, 8, 12
SCALE, T_SCALE, BIAS = 14.3, 30.0, -2.5


def _rows(seed: int, d: int = D) -> np.ndarray:
    x = np.random.default_rng(seed).normal(size=(B, d))
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


INPUTS = {"img": _rows(1), "txt": _rows(2), "t_img": _rows(3, DT), "t_txt": _rows(4, DT),
          "dino": np.random.default_rng(5).normal(size=(B, 6)).astype(np.float32)}


def _port_case(case, img, txt, scale):
    t_img, t_txt = (torch.from_numpy(INPUTS[k]) for k in ("t_img", "t_txt"))
    if case.startswith("cyclip"):
        lam = (0.25, 0.25) if case == "cyclip" else (0.7, 0.1)
        return tl.cyclip_loss(img, txt, scale, *lam)
    return tl.distill_clip_loss(img, txt, scale, t_img, t_txt, torch.tensor(T_SCALE))


def _jax_case(case, img, txt, scale):
    import jax.numpy as jnp

    from refining_clip_via_dinov2_representations_tpu.losses import contrastive as jc

    t_img, t_txt = (jnp.asarray(INPUTS[k]) for k in ("t_img", "t_txt"))
    if case.startswith("cyclip"):
        lam = (0.25, 0.25) if case == "cyclip" else (0.7, 0.1)
        return jc.cyclip_loss(img, txt, scale, *lam)
    return jc.distill_clip_loss(img, txt, scale, t_img, t_txt, jnp.float32(T_SCALE))


def _close(got, want, what):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=1e-6,
                               atol=1e-6 * max(float(np.abs(want).max()), 1e-30), err_msg=what)


@pytest.mark.parametrize("case", ["cyclip", "cyclip_lambdas", "distill"])
def test_losses_and_gradients_match_jax(case):
    import jax
    import jax.numpy as jnp

    def port(key):
        img, txt = (torch.from_numpy(INPUTS[k]).requires_grad_() for k in ("img", "txt"))
        scale = torch.tensor(SCALE, requires_grad=True)
        out = _port_case(case, img, txt, scale)
        out[key].backward()
        return out, (img.grad, txt.grad, scale.grad)

    args = (jnp.asarray(INPUTS["img"]), jnp.asarray(INPUTS["txt"]), jnp.float32(SCALE))
    want = _jax_case(case, *args)
    keys = ["total_loss"] if case.startswith("cyclip") else ["contrastive_loss", "distill_loss"]
    for key in keys:
        got, grads = port(key)
        assert sorted(got) == sorted(want)
        for k in want:
            _close(float(got[k].detach()), want[k], f"{case} {k}")
        jgrads = jax.grad(lambda i, t, s: _jax_case(case, i, t, s)[key], argnums=(0, 1, 2))(*args)
        for g, w, name in zip(grads, jgrads, ("img", "txt", "logit_scale")):
            _close(g.numpy(), w, f"{case} d{key}/d{name}")


def test_bf16_rows_promote_to_fp32_as_in_jax():
    import jax.numpy as jnp

    from refining_clip_via_dinov2_representations_tpu.losses import contrastive as jc

    img, txt = (torch.from_numpy(INPUTS[k]).bfloat16() for k in ("img", "txt"))
    got = tl.cyclip_loss(img, txt, torch.tensor(SCALE))
    ji, jt = (jnp.asarray(INPUTS[k]).astype(jnp.bfloat16) for k in ("img", "txt"))
    want = jc.cyclip_loss(ji, jt, jnp.float32(SCALE))
    for k in want:
        assert got[k].dtype == torch.float32
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, err_msg=k)
    t_img, t_txt = (torch.from_numpy(INPUTS[k]).bfloat16() for k in ("t_img", "t_txt"))
    got = tl.distill_clip_loss(img, txt, torch.tensor(SCALE), t_img, t_txt,
                               torch.tensor(T_SCALE))
    want = jc.distill_clip_loss(ji, jt, jnp.float32(SCALE),
                                jnp.asarray(INPUTS["t_img"]).astype(jnp.bfloat16),
                                jnp.asarray(INPUTS["t_txt"]).astype(jnp.bfloat16),
                                jnp.float32(T_SCALE))
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, err_msg=k)


def test_zero_rows_keep_the_norm_floor():
    img = torch.zeros(B, D)
    out = tl.cyclip_loss(img, torch.from_numpy(INPUTS["txt"]), torch.tensor(SCALE))
    assert all(torch.isfinite(v) for v in out.values())


# ------------------------------------------------------------------ classes

def _class_args(name):
    """(constructor kwargs, call args as numpy) of each class."""
    img, txt = INPUTS["img"], INPUTS["txt"]
    rng = np.random.default_rng(9)
    if name == "ClipLoss":
        return {}, (img, txt, SCALE)
    if name == "CoCaLoss":
        logits = rng.normal(size=(B, 5, 11)).astype(np.float32)
        labels = rng.integers(0, 11, size=(B, 5)).astype(np.int32)
        return dict(caption_loss_weight=2.0, clip_loss_weight=1.0), (img, txt, logits, labels,
                                                                       SCALE)
    if name == "DistillClipLoss":
        return {}, (img, txt, SCALE, INPUTS["t_img"], INPUTS["t_txt"], T_SCALE)
    if name == "SigLipLoss":
        return {}, (img, txt, SCALE, BIAS)
    if name == "CyCLIPLoss":
        return dict(lambda_inmodal=0.3, lambda_crossmodal=0.6), (img, txt, SCALE)
    return dict(cfg="dino"), (img, txt, SCALE, INPUTS["dino"])


CLASSES = ["ClipLoss", "CoCaLoss", "DistillClipLoss", "SigLipLoss", "CyCLIPLoss",
           "ClipLossWithDINOEnhancements"]


def _to(arg, lib):
    if lib == "torch":
        if isinstance(arg, float):
            return torch.tensor(arg)
        t = torch.from_numpy(arg)
        return t.long() if t.dtype == torch.int32 else t
    import jax.numpy as jnp

    return jnp.float32(arg) if isinstance(arg, float) else jnp.asarray(arg)


@pytest.mark.parametrize("output_dict", [False, True])
@pytest.mark.parametrize("name", CLASSES)
def test_classes_match_the_jax_classes(name, output_dict):
    from refining_clip_via_dinov2_representations_tpu.losses import compat as jcompat
    from refining_clip_via_dinov2_representations_tpu.losses import DinoLossCfg as JaxCfg

    kw, args = _class_args(name)
    tkw, jkw = dict(kw), dict(kw)
    if kw.get("cfg") == "dino":
        dino = dict(lambda_soft=0.5, soft_mode="kl_teacher", lambda_weighted=0.3,
                    use_projection=False)
        tkw["cfg"], jkw["cfg"] = tl.DinoLossCfg(**dino), JaxCfg(**dino)
    got = getattr(tcompat, name)(**tkw)
    assert isinstance(got, torch.nn.Module)
    got = got(*[_to(a, "torch") for a in args], output_dict=output_dict)
    want = getattr(jcompat, name)(**jkw)(*[_to(a, "jax") for a in args], output_dict=output_dict)
    if want is None:  # ClipLossWithDINOEnhancements without output_dict
        assert got is None
        return
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        pairs = [(got[k], want[k], k) for k in want]
    elif isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        pairs = [(g, w, str(i)) for i, (g, w) in enumerate(zip(got, want))]
    else:
        pairs = [(got, want, "loss")]
    for g, w, k in pairs:
        if isinstance(w, float):  # CyCLIP's lambdas
            assert g == w, k
            continue
        assert tuple(np.shape(g)) == tuple(np.shape(w)), k
        np.testing.assert_allclose(np.asarray(g.detach(), np.float64), np.asarray(w, np.float64),
                                   rtol=1e-5, atol=1e-7, err_msg=f"{name} {k}")


def test_distributed_arguments_are_checked_as_in_jax():
    from refining_clip_via_dinov2_representations_tpu.losses import compat as jcompat

    for lib in (tcompat, jcompat):
        with pytest.raises(ValueError, match="world_size>1"):
            lib.ClipLoss(world_size=2)
        with pytest.raises(ValueError, match="horovod"):
            lib.ClipLoss(use_horovod=True)
        with pytest.raises(ValueError, match="world_size>1"):
            lib.SigLipLoss(world_size=4)
    # one process: the knobs the reference takes are accepted
    assert tcompat.ClipLoss(gather_with_grad=True, cache_labels=True, rank=0).group is None
    assert tcompat.SigLipLoss(bidir=False).dist_impl == "shift"
    assert tcompat.SigLipLoss().dist_impl == "bidir"


def test_dino_class_reads_per_step_args_and_refuses_a_missing_projection():
    loss = tcompat.ClipLossWithDINOEnhancements(
        cfg=tl.DinoLossCfg(lambda_soft=0.5, soft_mode="kl_teacher", use_projection=False))
    img, txt, scale, dino = (_to(a, "torch") for a in _class_args("x")[1])
    base = loss(img, txt, scale, dino, output_dict=True)
    more = loss(img, txt, scale, dino, args=argparse.Namespace(lambda_soft=1.5),
                output_dict=True)
    assert float(more["total_loss"]) != float(base["total_loss"])
    np.testing.assert_allclose(float(more["total_loss"] - base["total_loss"]),
                               float(base["soft_loss"]), rtol=1e-5)
    with pytest.raises(ValueError, match="image_proj"):
        loss(img, txt, scale, dino, args=argparse.Namespace(use_projection=True))


DISPATCH = [
    (dict(distill=True, model="coca_ViT-B-32", use_CyClip=True), "DistillClipLoss"),
    (dict(model="coca_ViT-B-32", siglip=True), "CoCaLoss"),
    (dict(model="ViT-B-16", use_coca=True, siglip=True), "CoCaLoss"),
    (dict(model="ViT-B-16", siglip=True, use_CyClip=True, loss_dist_impl="gather"),
     "SigLipLoss"),
    (dict(model="ViT-B-16", use_CyClip=True, use_dino_general=True, lambda_cyc_inmodal=0.4),
     "CyCLIPLoss"),
    (dict(model="ViT-B-16", use_cyclip=True), "CyCLIPLoss"),
    (dict(model="ViT-B-16", use_dino_general=True, lambda_soft=0.5, use_projection=False),
     "ClipLossWithDINOEnhancements"),
    (dict(model="ViT-B-16", local_loss=True), "ClipLoss"),
]


@pytest.mark.parametrize("flags,name", DISPATCH)
def test_create_loss_dispatches_as_jax(flags, name):
    from refining_clip_via_dinov2_representations_tpu.losses import compat as jcompat

    args = argparse.Namespace(**flags)
    got, want = tcompat.create_loss(args), jcompat.create_loss(args)
    assert type(got).__name__ == type(want).__name__ == name
    for attr in ("local_loss", "dist_impl", "lambda_inmodal", "lambda_crossmodal",
                 "caption_loss_weight", "clip_loss_weight"):
        if hasattr(want, attr):
            assert getattr(got, attr) == getattr(want, attr), attr
    if name == "ClipLossWithDINOEnhancements":
        assert got.cfg.lambda_soft == want.cfg.lambda_soft == 0.5
        assert got.cfg.use_projection is want.cfg.use_projection is False
    assert tl.create_loss is tcompat.create_loss
