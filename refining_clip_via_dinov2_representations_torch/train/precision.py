"""Precision helpers.

As in the JAX package there is no autocast and no GradScaler: the compute
dtype is fixed when the model is built (``models/factory.py:
_precision_to_dtype``), and the layers cast their fp32 parameters to the
dtype of their input. These helpers keep the reference's API shape, with
the JAX package's mapping (fp16 flags map to bf16).
"""

from __future__ import annotations

import contextlib

import torch

_BF16_FLAGS = ("bf16", "pure_bf16", "amp_bf16", "amp_bfloat16", "fp16", "pure_fp16")


def get_cast_dtype(precision: str):
    """Weight/compute dtype for a precision flag, or None for fp32."""
    return torch.bfloat16 if precision in _BF16_FLAGS else None


def get_input_dtype(precision: str):
    """Input-pixel dtype for a precision flag."""
    return torch.bfloat16 if precision in _BF16_FLAGS else torch.float32


def get_autocast(precision: str, device_type: str = "cuda"):
    """A null context: the compute dtype is a property of the built model."""
    return contextlib.nullcontext
