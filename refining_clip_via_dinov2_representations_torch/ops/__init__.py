"""Attention ops: the Hopper kernels, their plain versions and the dispatch.

Importing this package registers the kernels' ``torch.library`` custom ops
(``rcd_torch::fused_attention_fwd``, ``rcd_torch::fused_attention_bwd``,
``rcd_torch::flash_attention_fwd``), which an exported program calls."""

from . import flash_attention, fused_attention  # noqa: F401
