"""Weight bridge: the reference's parameter tree, as numpy arrays, to
the port's tensors.

The reference lays a decoder's parameters out as ``embed``,
``final_norm``, the ``prefix`` list of per-layer dicts, and ``blocks``:
one dict per block position whose leaves are stacked on a leading
``n_blocks`` dim (its ``models/transformer.py::decoder_param_schema``).
The port keeps the same tree, so the bridge converts leaf by leaf and
any tree of dicts and lists of arrays (a router MLP's params too)
crosses the same way.

Leaves may be float32 / int32 arrays or ``ml_dtypes`` bfloat16 arrays
(what ``np.asarray`` gives for a bf16 JAX array); bfloat16 crosses
bit-exactly through a 16-bit integer view.  The caller converts its
framework arrays to numpy first, so nothing here imports JAX.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.device import resolve_device


def tensor_from_numpy(a: np.ndarray, device) -> torch.Tensor:
    # an own, writable, C-contiguous copy: the tensor never aliases the
    # caller's (often read-only) array
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def params_from_numpy(tree, *, device="cuda") -> Any:
    """Convert a dict/list tree of numpy arrays to torch tensors on
    ``device``, keeping its structure and each leaf's dtype."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [conv(v) for v in x]
        return tensor_from_numpy(np.asarray(x), dev)

    return conv(tree)
