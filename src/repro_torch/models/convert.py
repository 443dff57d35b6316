"""Carry the JAX package's params across into the port.

The port keeps the reference's layout, so the transfer is a flatten of
the nested pytree to dotted keys and a copy of each leaf: no transposes.
The caller turns the JAX arrays into numpy first (``np.asarray`` per
leaf), so this module needs no JAX.
"""
from __future__ import annotations

import numpy as np
import torch


def params_from_numpy(tree, prefix="") -> dict:
    """Nested {name: array | dict} -> flat {dotted key: torch tensor}, a
    state_dict that ``ViT(cfg, sd)`` or ``ViT.load_state_dict`` takes."""
    out = {}
    for name, leaf in tree.items():
        key = f"{prefix}{name}"
        if isinstance(leaf, dict):
            out.update(params_from_numpy(leaf, key + "."))
        else:
            out[key] = torch.from_numpy(np.array(leaf))
    return out
