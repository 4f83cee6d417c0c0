"""Dtype names → torch dtypes.

Counterpart of `lwm_tpu/utils/dtypes.py:17-20` (`get_float_dtype_by_name`).
"""

import torch

_FLOAT_DTYPES = {
    "bf16": torch.bfloat16,
    "bfloat16": torch.bfloat16,
    "fp16": torch.float16,
    "float16": torch.float16,
    "fp32": torch.float32,
    "float32": torch.float32,
    "fp64": torch.float64,
    "float64": torch.float64,
}


def get_float_dtype_by_name(name):
    """'bf16' → torch.bfloat16, ...; a torch dtype passes through."""
    if not isinstance(name, str):
        return name
    return _FLOAT_DTYPES[name]
