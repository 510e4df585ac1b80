"""Checkpointing: flat-key npz, the reference's format.

``params_<step>.npz`` (and ``opt_<step>.npz``) hold one array per leaf
under the key the reference's ``training/checkpoint.py::_flatten``
builds: the dict keys and list indices on the leaf's path joined by
``/`` (``embed``, ``blocks/p0/attn/wq``, ``m/final_norm``, ``step``).
bfloat16 is stored as float32 (numpy has no bfloat16), and
``latest.json`` names the step.  On load each leaf's shape is checked
against the template and the array is cast to the template leaf's dtype
and device.  So a checkpoint written by either package loads in the
other.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch


def _paths(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(key, leaf) pairs, dict keys in sorted order (JAX's)."""
    if isinstance(tree, dict):
        items = ((k, tree[k]) for k in sorted(tree))
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        yield prefix, tree
        return
    for k, sub in items:
        yield from _paths(sub, f"{prefix}/{k}" if prefix else str(k))


def _flatten(tree) -> Dict[str, np.ndarray]:
    flat = {}
    for key, leaf in _paths(tree):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:  # numpy can't serialize bf16
            t = t.float()
        flat[key] = t.cpu().numpy()
    return flat


def save_checkpoint(path, step: int, params, opt_state=None,
                    extra: dict | None = None):
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path / f"params_{step}.npz", **_flatten(params))
    if opt_state is not None:
        np.savez_compressed(path / f"opt_{step}.npz", **_flatten(opt_state))
    meta = {"step": step, "extra": extra or {}}
    (path / "latest.json").write_text(json.dumps(meta))
    return path / f"params_{step}.npz"


def _unflatten_into(template, flat: Dict[str, np.ndarray], prefix: str = ""):
    if isinstance(template, dict):
        return {k: _unflatten_into(template[k], flat,
                                   f"{prefix}/{k}" if prefix else str(k))
                for k in template}
    if isinstance(template, (list, tuple)):
        return [_unflatten_into(t, flat, f"{prefix}/{i}" if prefix else str(i))
                for i, t in enumerate(template)]
    if prefix not in flat:
        raise KeyError(f"checkpoint has no leaf {prefix!r}")
    arr = flat[prefix]
    if tuple(arr.shape) != tuple(template.shape):
        raise ValueError(f"checkpoint leaf {prefix!r} has shape {arr.shape}, "
                         f"the template {tuple(template.shape)}")
    return torch.from_numpy(np.array(arr)).to(device=template.device,
                                              dtype=template.dtype)


def load_checkpoint(path, template_params,
                    template_opt=None) -> Tuple[int, Any, Any]:
    """Returns (step, params, opt_state) as new trees shaped, typed and
    placed as the templates (``opt_state`` None when not asked for or
    not saved)."""
    path = Path(path)
    meta = json.loads((path / "latest.json").read_text())
    step = meta["step"]
    with np.load(path / f"params_{step}.npz") as z:
        params = _unflatten_into(template_params, dict(z))
    opt = None
    if template_opt is not None and (path / f"opt_{step}.npz").exists():
        with np.load(path / f"opt_{step}.npz") as zo:
            opt = _unflatten_into(template_opt, dict(zo))
    return step, params, opt
