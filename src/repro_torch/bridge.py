"""Parameter bridge between the two packages: the JAX parameter pytree,
given as numpy leaves, becomes the port's nested dict of tensors with the
same leaf names and the same stacked ``[L, ...]`` per-block layout.

``jax.random`` draws cannot be reproduced in torch, so this is how the tests
run both packages on the same weights (``init_params`` or
``nondegenerate_params`` output of ``repro.models.diffusion.dit``, and
``repro.models.diffusion.unet.init_params``, whose levels are lists and
whose last ``downsample`` is None). numpy
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


def params_from_jax(tree, device, dtype: Optional[torch.dtype] = None):
    """Nested mappings and lists of array leaves -> the same structure of
    tensors on ``device`` (a None subtree, like the UNet's last
    ``downsample``, stays None). ``dtype`` casts every leaf; None keeps
    each leaf's dtype."""
    if tree is None:
        return None
    if isinstance(tree, Mapping):
        return {k: params_from_jax(v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_jax(v, device, dtype) for v in tree)
    return _leaf_to_tensor(tree, device, dtype)


def params_to_numpy(params):
    """The inverse direction for checks: tensors -> float32-or-wider numpy
    leaves (bfloat16 widened to float32, which is exact), in the same
    structure of mappings, lists and None."""
    if params is None:
        return None
    if isinstance(params, Mapping):
        return {k: params_to_numpy(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(params_to_numpy(v) for v in params)
    v = params.detach()
    return (v.float() if v.dtype == torch.bfloat16 else v).cpu().numpy()
