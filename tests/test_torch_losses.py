"""The port's contrastive and DINO-soft losses against the JAX package.

The same seeded numpy features, DINO features, logit scale and projection
head parameters go through the JAX loss (``jax.value_and_grad``) and the
port's (autograd); the values and the gradients with respect to the image
and text features, the logit scale and every head parameter must agree.
Tolerance in fp32: 2e-5 absolute plus 1e-4 relative (summation order and
the last bits of exp/log; the soft term divides similarities by a
temperature of 0.02, which scales rounding by 50).
"""

import dataclasses

import numpy as np
import pytest
import torch

from refining_clip_via_dinov2_representations_torch.losses import (
    DinoLossCfg,
    DinoProjectionHead,
    clip_loss,
    compute_student_tau,
    dino_enhanced_loss,
)
from refining_clip_via_dinov2_representations_torch.models.convert import (
    jax_head_params_to_state_dict,
)

ATOL, RTOL = 2e-5, 1e-4
B, E = 8, 16


def _features(dino_dim, seed=0):
    rng = np.random.default_rng(seed)
    unit = lambda x: (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)  # noqa: E731
    return (unit(rng.normal(size=(B, E))), unit(rng.normal(size=(B, E))),
            rng.normal(size=(B, dino_dim)).astype(np.float32), np.float32(14.285714))


def _jax_head(dino_dim, projection_type, use_layernorm, seed=0):
    import jax
    import jax.numpy as jnp

    from refining_clip_via_dinov2_representations_tpu.losses.dino import (
        DinoProjectionHead as JaxHead,
    )

    head = JaxHead(dino_dim=dino_dim, projection_type=projection_type,
                   use_layernorm=use_layernorm)
    params = head.init(jax.random.PRNGKey(seed), jnp.zeros((1, E)))["params"]
    rng = np.random.default_rng(seed + 1)
    params = jax.tree.map(  # move LayerNorm scale/bias off their init constants
        lambda x: np.asarray(x) + rng.normal(0.0, 0.05, np.shape(x)).astype(np.float32), params)
    return head, params


CASES = {
    "mlp": dict(projection_type="mlp"),
    "linear": dict(projection_type="linear"),
    "mlp_layernorm": dict(projection_type="mlp", use_layernorm=True),
    "linear_layernorm": dict(projection_type="linear", use_layernorm=True),
    "residual": dict(projection_type="linear", residual_projection=True),
    "residual_alpha": dict(projection_type="mlp", residual_projection=True, residual_alpha=0.3),
    "soft_to_text": dict(soft_dino_to_text=True, text_lambda=0.4),
    "weighted": dict(lambda_weighted=0.5),
    "weighted_symmetric": dict(lambda_weighted=0.5, weight_text_symmetry=True),
    "weighted_diagnostics": dict(lambda_weighted=0.5, weight_text_symmetry=True,
                                 with_diagnostics=True),
    "no_projection": dict(use_projection=False, lambda_weighted=0.3),
    "no_dino_features": dict(),
}


@pytest.mark.parametrize("case", list(CASES))
def test_dino_enhanced_loss_values_and_gradients_match_jax(case):
    import jax
    import jax.numpy as jnp

    from refining_clip_via_dinov2_representations_tpu.losses.dino import (
        DinoLossCfg as JaxCfg,
        dino_enhanced_loss as jax_loss,
    )

    kw = dict(lambda_soft=0.7, soft_mode="kl_teacher", **CASES[case])
    residual = kw.get("residual_projection", False)
    dino_dim = E if residual else 12
    img, txt, dino, scale = _features(dino_dim, seed=len(case))
    with_dino = case != "no_dino_features"
    jcfg, cfg = JaxCfg(**kw), DinoLossCfg(**kw)
    head, hparams = _jax_head(dino_dim, cfg.projection_type, cfg.use_layernorm)
    use_head = cfg.use_projection and with_dino

    def f(i, t, s, hp):
        proj = head.apply({"params": hp}, i) if use_head else None
        out = jax_loss(i, t, s, jnp.asarray(dino) if with_dino else None, jcfg, image_proj=proj)
        return out["total_loss"], out

    (j_total, j_out), j_grads = jax.value_and_grad(f, argnums=(0, 1, 2, 3), has_aux=True)(
        jnp.asarray(img), jnp.asarray(txt), jnp.asarray(scale), hparams)

    port_head = DinoProjectionHead(E, dino_dim, cfg.projection_type, cfg.use_layernorm)
    port_head.load_state_dict(jax_head_params_to_state_dict(hparams), strict=True)
    ti, tt = torch.tensor(img, requires_grad=True), torch.tensor(txt, requires_grad=True)
    ts = torch.tensor(scale, requires_grad=True)
    out = dino_enhanced_loss(ti, tt, ts, torch.from_numpy(dino) if with_dino else None, cfg,
                             image_proj=port_head(ti) if use_head else None)
    out["total_loss"].backward()

    assert set(out) == set(j_out)
    for k in j_out:
        np.testing.assert_allclose(out[k].detach().numpy(), np.asarray(j_out[k]), atol=ATOL,
                                   rtol=RTOL, err_msg=k)
    for name, got, want in (("image_features", ti.grad, j_grads[0]),
                            ("text_features", tt.grad, j_grads[1]),
                            ("logit_scale", ts.grad, j_grads[2])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=RTOL,
                                   err_msg=name)
    if use_head:
        want = jax_head_params_to_state_dict(jax.device_get(j_grads[3]))
        for name, p in port_head.named_parameters():
            np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), atol=ATOL,
                                       rtol=RTOL, err_msg=f"head {name}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_clip_loss_value_and_gradients_match_jax(dtype):
    """bf16 features promote to fp32 at the fp32 logit scale, as in JAX."""
    import jax
    import jax.numpy as jnp

    from refining_clip_via_dinov2_representations_tpu.losses.contrastive import (
        clip_loss as jax_clip_loss,
    )

    img, txt, _, scale = _features(4, seed=3)
    jd = getattr(jnp, dtype)
    j_val, j_grads = jax.value_and_grad(jax_clip_loss, argnums=(0, 1, 2))(
        jnp.asarray(img, jd), jnp.asarray(txt, jd), jnp.asarray(scale))
    td = getattr(torch, dtype)
    ti = torch.tensor(img).to(td).requires_grad_()
    tt = torch.tensor(txt).to(td).requires_grad_()
    ts = torch.tensor(scale, requires_grad=True)
    val = clip_loss(ti, tt, ts)
    val.backward()
    tol = ATOL if dtype == "float32" else 1e-2  # bf16 gradients: one ulp is 2^-8
    np.testing.assert_allclose(val.item(), float(j_val), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(j_grads[2]), atol=ATOL, rtol=RTOL)
    for got, want in ((ti.grad, j_grads[0]), (tt.grad, j_grads[1])):
        assert got.dtype == td
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                                   atol=tol, rtol=tol)


@pytest.mark.parametrize("value", [2.0, 2.6593, 4.6, 9.99, 10.01, 14.2857, 50.0, 150.0])
def test_compute_student_tau_matches_jax_on_both_sides_of_10(value):
    import jax.numpy as jnp

    from refining_clip_via_dinov2_representations_tpu.losses.dino import (
        compute_student_tau as jax_tau,
    )

    s = torch.tensor(value, requires_grad=True)
    got = compute_student_tau(s)
    assert not got.requires_grad  # no gradient through the temperature
    np.testing.assert_allclose(got.item(), float(jax_tau(jnp.asarray(value))), rtol=1e-6)


def test_soft_kl_is_finite_with_a_masked_teacher_diagonal():
    """q is 0 on the diagonal: 0 * log 0 must not become NaN, in value or grad."""
    img, txt, dino, scale = _features(12, seed=9)
    ti = torch.tensor(img, requires_grad=True)
    cfg = dataclasses.replace(DinoLossCfg(lambda_soft=1.0), use_projection=False)
    out = dino_enhanced_loss(ti, torch.from_numpy(txt), torch.tensor(scale),
                             torch.from_numpy(dino), cfg)
    out["total_loss"].backward()
    assert torch.isfinite(out["soft_loss"]) and out["soft_loss"] > 0
    assert torch.isfinite(ti.grad).all()


@pytest.mark.parametrize("projection_type", ["mlp", "linear"])
def test_head_init_follows_the_jax_heads(projection_type):
    """The head's init has the JAX (flax ``Dense``) head's distribution:
    zero biases and lecun-normal weights, a normal truncated at two standard
    deviations with variance 1 / fan_in (torch's ``nn.Linear`` default draws
    uniform weights of a third of that variance and non-zero biases). At the
    ViT-B-16 shapes (512 -> 448 -> 384) each weight's standard deviation is
    estimated from 1.7e5 or more draws: within 2 % of the JAX head's."""
    import jax
    import jax.numpy as jnp

    from refining_clip_via_dinov2_representations_tpu.losses.dino import (
        DinoProjectionHead as JaxHead,
    )

    torch.manual_seed(1)
    port = DinoProjectionHead(512, 384, projection_type)
    jax_params = JaxHead(dino_dim=384, projection_type=projection_type).init(
        jax.random.PRNGKey(1), jnp.zeros((1, 512)))["params"]
    got = {k: v.detach().numpy() for k, v in port.state_dict().items()}
    want = jax_head_params_to_state_dict(jax_params)
    assert got.keys() == {k: v for k, v in want.items()}.keys()
    for name, w in want.items():
        w, g = np.asarray(w), got[name]
        assert g.shape == w.shape, name
        if name.endswith("bias"):
            assert not g.any() and not w.any(), name
            continue
        bound = 2.0 / 0.87962566103423978 / np.sqrt(g.shape[1])  # two standard deviations
        assert np.abs(g).max() <= bound and np.abs(w).max() <= bound * (1 + 1e-6), name
        assert g.std() == pytest.approx(w.std(), rel=0.02), name
        assert g.std() == pytest.approx(np.sqrt(1.0 / g.shape[1]), rel=0.02), name
