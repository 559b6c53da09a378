"""The remat policies of ``--remat-policy`` (``models/transformer.py``),
against the same model without checkpointing.

* Each policy's loss and gradients equal no-remat's on a 2-layer CLIP
  (both towers checkpointed), fp32, within 1e-6 absolute — the same ops on
  the same values, recomputed — through the plain attention (``"xla"``) and
  through the fused kernels' custom op (``"fused"``, whose plain versions
  run on the CPU: the op that selective checkpointing must run again, the
  kernel's case on the card), with patch dropout on.
* The dots policies keep only the ops they name: ``dots_saveable`` the
  ``mm``/``addmm`` of the projections and the ``bmm`` of plain attention,
  ``dots_with_no_batch_dims_saveable`` the ``mm``/``addmm`` alone (and the
  fused op, which is no dot, is recomputed: one op to the policy, its plain
  version inside it as the kernel on the card); the
  offload policy copies the four ``addmm`` outputs of each block (qkv, out,
  c_fc, c_proj) to the host and hands them back in the recompute (which
  stops before c_proj: autograd saved nothing past it).
"""

import numpy as np
import pytest
import torch
from torch.utils.checkpoint import CheckpointPolicy

from refining_clip_via_dinov2_representations_torch.models import (
    build_model,
    parse_model_cfg,
    transformer,
)
from .torch_port_utils import TINY_CFG, images, token_ids

CFG = {**TINY_CFG, "vision_cfg": {**TINY_CFG["vision_cfg"], "patch_dropout": 0.5}}
ATOL = 1e-6


def _model(policy, impl):
    torch.manual_seed(0)
    model = build_model(parse_model_cfg(CFG), attn_impl=impl, seed=3,
                        grad_checkpointing=False if policy is None else policy)
    return model.train()


def _loss_and_grads(model):
    size, ctx = CFG["vision_cfg"]["image_size"], CFG["text_cfg"]["context_length"]
    out = model(torch.from_numpy(images(4, size)), torch.from_numpy(token_ids(4, ctx)).long(),
                patch_dropout_generator=torch.Generator().manual_seed(5))
    w = torch.linspace(-1, 1, out["image_features"].shape[-1])
    loss = ((out["image_features"] * w).sum() + (out["text_features"] * w.flip(0)).sum()
            + (out["logit_scale"] * out["image_features"] @ out["text_features"].t())
            .logsumexp(-1).sum())
    loss.backward()
    return loss.detach(), {n: p.grad.clone() for n, p in model.named_parameters()}


@pytest.mark.parametrize("impl", ["xla", "fused"])
@pytest.mark.parametrize("policy", transformer.REMAT_POLICIES)
def test_policy_gives_the_gradients_of_no_remat(policy, impl):
    want_loss, want = _loss_and_grads(_model(None, impl))
    model = _model(policy, impl)
    assert model.visual.transformer.grad_checkpointing and model.transformer.remat_policy == policy
    got_loss, got = _loss_and_grads(model)
    torch.testing.assert_close(got_loss, want_loss, atol=ATOL, rtol=0)
    assert got.keys() == want.keys()
    for n in want:
        torch.testing.assert_close(got[n], want[n], atol=ATOL, rtol=0, msg=n)


@pytest.mark.parametrize("policy,impl", [("dots_saveable", "xla"),
                                         ("dots_with_no_batch_dims_saveable", "xla"),
                                         ("dots_with_no_batch_dims_saveable", "fused")])
def test_dots_policies_save_only_the_ops_they_name(monkeypatch, policy, impl):
    decisions = []
    real = transformer.selective_policy

    def recording(name):
        fn = real(name)

        def policy_fn(ctx, op, *args, **kwargs):
            out = fn(ctx, op, *args, **kwargs)
            if not ctx.is_recompute:
                decisions.append((op, out))
            return out

        return policy_fn

    monkeypatch.setattr(transformer, "selective_policy", recording)
    _loss_and_grads(_model(policy, impl))
    saved = [op for op, d in decisions if d == CheckpointPolicy.MUST_SAVE]
    assert set(saved) <= transformer.saved_ops(policy)
    layers = CFG["vision_cfg"]["layers"] + CFG["text_cfg"]["layers"]
    addmm = torch.ops.aten.addmm.default
    assert saved.count(addmm) == 4 * layers  # in_proj, out_proj, c_fc, c_proj
    bmm = [op for op, _ in decisions if op in transformer.BATCH_DOTS]
    fused = [d for op, d in decisions if op == torch.ops.rcd_torch.fused_attention_fwd.default]
    if impl == "fused":
        # the attention of every block is the op, recomputed
        assert fused == [CheckpointPolicy.PREFER_RECOMPUTE] * layers and not bmm
        return
    assert bmm  # plain attention's products ran inside the blocks
    if policy == "dots_saveable":
        assert set(bmm) <= set(saved)
    else:
        assert not set(bmm) & set(saved)


def test_offload_copies_the_no_batch_dots_out_and_back(monkeypatch):
    stores = []
    real = transformer._offload_contexts

    def recording(ops):
        save, restore = real(ops)
        stores.append(save.storage)
        return save, restore

    monkeypatch.setattr(transformer, "_offload_contexts", recording)
    model = _model("offload_dots_with_no_batch_dims", "xla")
    size, ctx = CFG["vision_cfg"]["image_size"], CFG["text_cfg"]["context_length"]
    out = model(torch.from_numpy(images(2, size)), torch.from_numpy(token_ids(2, ctx)).long())
    layers = CFG["vision_cfg"]["layers"] + CFG["text_cfg"]["layers"]
    assert len(stores) == layers  # one pair of modes a checkpointed block
    for storage in stores:
        assert set(storage) == {torch.ops.aten.addmm.default}
        assert len(storage[torch.ops.aten.addmm.default]) == 4
        assert all(host.device.type == "cpu" for host, _ in storage[torch.ops.aten.addmm.default])
    (out["image_features"].sum() + out["text_features"].sum()).backward()
    # the recompute takes the copies back in order and stops after the last
    # tensor autograd saved: c_proj's output feeds only the residual add
    assert all(len(s[torch.ops.aten.addmm.default]) <= 1 for s in stores)


def test_policy_names_as_in_jax():
    from refining_clip_via_dinov2_representations_tpu.models.transformer import (
        _resolve_remat_policy,
    )

    for name in transformer.REMAT_POLICIES:
        _resolve_remat_policy(name)  # each port name is one the JAX package resolves
        assert transformer.remat_args(name) == (True, name)
    assert transformer.remat_args(True) == (True, "full")
    assert transformer.remat_args(False) == (False, "full")
    with pytest.raises(ValueError, match="unknown remat policy"):
        build_model(parse_model_cfg(CFG), grad_checkpointing="save_everything")
    with pytest.raises(KeyError):
        _resolve_remat_policy("save_everything")
    # no checkpointing in eval or under no_grad, whatever the policy
    model = _model("dots_saveable", "xla").eval()
    with torch.no_grad():
        size, ctx = CFG["vision_cfg"]["image_size"], CFG["text_cfg"]["context_length"]
        model(torch.from_numpy(images(1, size)), torch.from_numpy(token_ids(1, ctx)).long())
    np.testing.assert_equal(model.transformer.remat_policy, "dots_saveable")


@pytest.mark.cuda
@pytest.mark.parametrize("policy", transformer.REMAT_POLICIES)
def test_cuda_vit_g14_block_under_each_policy(policy):
    """One ViT-g-14-width block (1408 wide, 16 heads of 88, MLP 6144, 257
    tokens) in bf16 on the card: under each policy the fused forward runs
    twice (the recompute relaunches it) and the backward once, and the
    gradients equal the block's without checkpointing (the same kernels and
    GEMMs on the same values: 1e-6 of the largest |grad|)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from refining_clip_via_dinov2_representations_torch.ops.fused_attention import (
        fused_attention_bwd,
        fused_attention_fwd,
    )

    def run(remat):
        tower = transformer.Transformer(1408, 1, 16, mlp_ratio=4.3637, attn_impl="auto",
                                        grad_checkpointing=remat, remat_policy=policy)
        g = torch.Generator().manual_seed(0)
        with torch.no_grad():  # the Transformer alone leaves in_proj_weight uninitialised
            for p in tower.parameters():
                p.copy_(torch.randn(p.shape, generator=g) * 0.03)
        tower = tower.cuda().train()
        x = torch.randn(2, 257, 1408, generator=torch.Generator().manual_seed(1)).cuda()
        x = x.bfloat16().requires_grad_()
        fwd, bwd = fused_attention_fwd.launches, fused_attention_bwd.launches
        tower(x).float().square().mean().backward()
        torch.cuda.synchronize()
        launches = (fused_attention_fwd.launches - fwd, fused_attention_bwd.launches - bwd)
        return launches, [x.grad] + [p.grad for p in tower.parameters()]

    launches, got = run(True)
    plain_launches, want = run(False)
    assert launches == (2, 1) and plain_launches == (1, 1)
    largest = max(w.float().abs().max().item() for w in want)
    for g_, w in zip(got, want):
        assert (g_.float() - w.float()).abs().max().item() <= 1e-6 * largest
