"""The tensor-parallel layers on two gloo ranks against the unsplit modules.

Each rank builds every module whole from a seed, runs it forward and
backward on seeded inputs and cotangents, then splits a copy over the
model group of the two ranks (``parallel/tensor.py:shard_module``) and
does the same: the packed-QKV attention (not causal and causal), the MLP,
the text tower's width-split token embedding (a one-block tower), DINOv2's
attention with separate query/key/value Linears, its SwiGLU FFN (the packed
gate and value), the DINO head's mlp, a two-block residual stack under each
``--remat-policy`` (the recompute re-issues the row-parallel all-reduce on
both ranks alike), and the whole tiny DINOv2 teacher, forward only (plain
and SwiGLU, CLS features). The outputs equal the unsplit module's at 1e-6
of their largest magnitude, the inputs' gradients and every parameter's
gradient (the split ones gathered whole) at 1e-6 of the largest gradient
magnitude of the case (the attention's key-bias gradient is zero but for
rounding), fp32 on the CPU. No JAX: the
rules are held against the JAX spec in ``test_torch_tp_spec.py``.
"""

import pytest

from .torch_dist_utils import run_ranks

W = 2
CASES = ("attn", "attn-causal", "mlp", "text-embedding", "dinov2-attn", "swiglu", "dino-head")
POLICIES = ("none", "full", "dots_saveable", "dots_with_no_batch_dims_saveable",
            "offload_dots_with_no_batch_dims")


def _modules(case):
    """(module, input, forward) of ``case``, seeded."""
    import torch

    from refining_clip_via_dinov2_representations_torch.losses.dino import DinoProjectionHead
    from refining_clip_via_dinov2_representations_torch.models import dinov2
    from refining_clip_via_dinov2_representations_torch.models.layers import (
        MLP, MultiheadAttention,
    )
    from refining_clip_via_dinov2_representations_torch.models.transformer import (
        TextTransformer, Transformer,
    )

    def held(name, layer):  # under the attribute name its block gives it
        holder = torch.nn.Module()
        setattr(holder, name, layer)
        return holder

    torch.manual_seed(7)
    x = torch.randn(3, 6, 32)
    if case.startswith("attn"):
        m = MultiheadAttention(32, 4, attn_impl="xla")
        torch.nn.init.normal_(m.in_proj_weight, std=0.2)
        torch.nn.init.normal_(m.in_proj_bias, std=0.2)
        return held("attn", m), x, lambda m, x: m.attn(x, causal=case == "attn-causal")
    if case == "mlp":
        return held("mlp", MLP(32, 128)), x, lambda m, x: m.mlp(x)
    if case == "text-embedding":
        m = TextTransformer(context_length=6, vocab_size=50, width=32, heads=4, layers=1,
                            output_dim=16, attn_impl="xla")
        for p in m.parameters():
            torch.nn.init.normal_(p, std=0.2)
        ids = torch.randint(1, 49, (3, 6))
        return m, ids, lambda m, ids: m(ids)
    if case == "dinov2-attn":
        return held("attention", dinov2._Attention(32, 4, "xla")), x, lambda m, x: m.attention(x)
    if case == "swiglu":
        return held("mlp", dinov2._SwiGLUFFN(32, 96)), x, lambda m, x: m.mlp(x)
    if case == "dino-head":
        return DinoProjectionHead(32, 24, "mlp", use_layernorm=True), x[:, 0], lambda m, x: m(x)
    policy = case.split(":")[1]  # "remat:<policy>"
    m = Transformer(32, 2, 4, attn_impl="xla", grad_checkpointing=policy != "none",
                    remat_policy="full" if policy == "none" else policy)
    for p in m.parameters():
        torch.nn.init.normal_(p, std=0.2)
    return m.train(), x, lambda m, x: m(x, causal=False)


def _run(module, x, fwd):
    """(output, input grad, {param: grad}) with a seeded cotangent."""
    import torch

    x = x.clone().requires_grad_(x.is_floating_point())
    out = fwd(module, x)
    cot = torch.randn(out.shape, generator=torch.Generator().manual_seed(11))
    (out * cot).sum().backward()
    return (out.detach(), None if x.grad is None else x.grad,
            {n: p.grad for n, p in module.named_parameters()})


def _worker(rank, world):
    import copy

    import torch

    from refining_clip_via_dinov2_representations_torch.models import Dinov2, Dinov2Cfg
    from refining_clip_via_dinov2_representations_torch.parallel.mesh import create_mesh
    from refining_clip_via_dinov2_representations_torch.parallel.tensor import (
        gather_tensor, model_parallel, shard_module,
    )
    from refining_clip_via_dinov2_representations_torch.train.distributed import model_group

    create_mesh(model=world, device_type="cpu")
    mp = model_parallel(model_group())
    errs = {}
    for case in CASES + tuple(f"remat:{p}" for p in POLICIES):
        whole, x, fwd = _modules(case)
        split = copy.deepcopy(whole)
        want = _run(whole, x, fwd)
        splits = shard_module(split, mp, head=case == "dino-head")
        assert splits, case
        got = _run(split, x, fwd)
        grads = {n: gather_tensor(g, splits[n], mp) if n in splits else g
                 for n, g in got[2].items()}
        pairs = [("out", got[0], want[0])] + [(f"grad {n}", grads[n], want[2][n])
                                              for n in want[2]]
        if want[1] is not None:
            pairs.append(("input grad", got[1], want[1]))
        # a gradient against the layer's largest: the key bias's is zero but
        # for rounding (a key bias shifts a row's scores alike)
        scale = max(float(b.abs().max()) for k, _, b in pairs if k != "out")
        errs[case] = {k: float((a - b).abs().max()) / (float(b.abs().max()) if k == "out"
                                                       else scale) for k, a, b in pairs}
    for swiglu in (False, True):
        cfg = Dinov2Cfg(hidden_size=48, layers=2, heads=4, mlp_ratio=2.0, patch_size=8,
                        native_image_size=16, use_swiglu_ffn=swiglu)
        whole = Dinov2(cfg).init_weights(5).eval()
        split = copy.deepcopy(whole)
        shard_module(split, mp)
        px = torch.randn(2, 3, 24, 24, generator=torch.Generator().manual_seed(3))
        with torch.no_grad():
            want, got = whole(px), split(px)
        errs[f"teacher-{'swiglu' if swiglu else 'mlp'}"] = {
            "cls": float((got - want).abs().max() / want.abs().max())}
    return errs


@pytest.fixture(scope="module")
def ranks():
    return run_ranks(_worker, W)


@pytest.mark.parametrize("case", CASES + tuple(f"remat:{p}" for p in POLICIES)
                         + ("teacher-mlp", "teacher-swiglu"))
def test_split_layer_equals_the_unsplit_module(ranks, case):
    for r, errs in enumerate(ranks):
        for what, err in errs[case].items():
            assert err <= 1e-6, f"rank {r} {case} {what}: {err}"
