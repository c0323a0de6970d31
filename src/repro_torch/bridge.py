"""Parameter bridge between the two packages: the JAX parameter pytree,
given as numpy leaves, becomes the port's nested dict of tensors with the
same leaf names and the same stacked ``[L, ...]`` per-block layout.

``jax.random`` draws cannot be reproduced in torch, so this is how the tests
run both packages on the same weights (``init_params`` or
``nondegenerate_params`` output of ``repro.models.diffusion.dit``). numpy
has no bfloat16 of its own: a bf16 JAX leaf arrives as an ``ml_dtypes``
array, which ``torch.from_numpy`` rejects, so it goes through float32
(lossless) and back to bfloat16.
"""
from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch


def _leaf_to_tensor(leaf, device, dtype: Optional[torch.dtype]) -> torch.Tensor:
    arr = np.array(leaf)          # a writable copy (JAX's views are read-only)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device=device, dtype=dtype or t.dtype)


def params_from_jax(tree: Mapping, device,
                    dtype: Optional[torch.dtype] = None) -> dict:
    """Nested mapping of array leaves -> nested dict of tensors on
    ``device``. ``dtype`` casts every leaf; None keeps each leaf's dtype."""
    return {k: (params_from_jax(v, device, dtype) if isinstance(v, Mapping)
                else _leaf_to_tensor(v, device, dtype))
            for k, v in tree.items()}


def params_to_numpy(params: Mapping) -> dict:
    """The inverse direction for checks: tensors -> float32-or-wider numpy
    leaves (bfloat16 widened to float32, which is exact)."""
    return {k: (params_to_numpy(v) if isinstance(v, Mapping)
                else (v.float() if v.dtype == torch.bfloat16 else v)
                .detach().cpu().numpy())
            for k, v in params.items()}
