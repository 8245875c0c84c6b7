"""Carry GPT weights between the JAX package and the port.

The JAX model's params are a tree of arrays (numpy here): ``wte/
embedding``, ``wpe``, ``ln_f/{scale,bias}`` and, per block, ``ln1``,
``qkv``, ``proj``, ``ln2``, ``up``, ``down`` — stacked along a leading
layer axis under ``blocks`` when the layers are ``nn.scan``-ned, or one
subtree ``block_<i>`` each when they are not. The port's ``state_dict``
has one ``blocks.<i>`` per layer. Dense kernels keep flax's ``[in, out]``
layout on both sides (the port multiplies ``x @ kernel``), and flax's
LayerNorm ``scale`` is the port's ``weight``. Both directions copy the
values bit for bit.
"""

from typing import Dict, Mapping

import numpy as np
import torch

_DENSE = ("qkv", "proj", "up", "down")
_NORMS = ("ln1", "ln2")


def _block_trees(tree: Mapping):
    if "blocks" in tree:
        stacked = tree["blocks"]
        n = np.asarray(stacked["qkv"]["kernel"]).shape[0]
        return [
            {name: {leaf: np.asarray(arr)[i] for leaf, arr in sub.items()}
             for name, sub in stacked.items()}
            for i in range(n)
        ]
    n = sum(1 for key in tree if key.startswith("block_"))
    return [tree[f"block_{i}"] for i in range(n)]


def params_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """JAX GPT params (a tree of arrays) -> the port's ``state_dict``."""
    flat = {
        "wte.weight": tree["wte"]["embedding"],
        "wpe": tree["wpe"],
        "ln_f.weight": tree["ln_f"]["scale"],
        "ln_f.bias": tree["ln_f"]["bias"],
    }
    for i, blk in enumerate(_block_trees(tree)):
        for name in _NORMS:
            flat[f"blocks.{i}.{name}.weight"] = blk[name]["scale"]
            flat[f"blocks.{i}.{name}.bias"] = blk[name]["bias"]
        for name in _DENSE:
            flat[f"blocks.{i}.{name}.kernel"] = blk[name]["kernel"]
            flat[f"blocks.{i}.{name}.bias"] = blk[name]["bias"]
    return {k: torch.from_numpy(np.array(v, copy=True)) for k, v in flat.items()}


def flax_from_params(state_dict: Mapping[str, torch.Tensor],
                     stacked: bool = True) -> Dict:
    """The port's ``state_dict`` -> JAX GPT params as numpy arrays:
    stacked under ``blocks`` (``scan_layers=True``) or one ``block_<i>``
    per layer."""
    np_of = {k: v.detach().cpu().numpy().copy() for k, v in state_dict.items()}
    n = 1 + max(int(k.split(".")[1]) for k in np_of if k.startswith("blocks."))
    blocks = []
    for i in range(n):
        blk = {}
        for name in _NORMS:
            blk[name] = {"scale": np_of[f"blocks.{i}.{name}.weight"],
                         "bias": np_of[f"blocks.{i}.{name}.bias"]}
        for name in _DENSE:
            blk[name] = {"kernel": np_of[f"blocks.{i}.{name}.kernel"],
                         "bias": np_of[f"blocks.{i}.{name}.bias"]}
        blocks.append(blk)
    tree = {
        "wte": {"embedding": np_of["wte.weight"]},
        "wpe": np_of["wpe"],
        "ln_f": {"scale": np_of["ln_f.weight"], "bias": np_of["ln_f.bias"]},
    }
    if stacked:
        tree["blocks"] = {
            name: {leaf: np.stack([b[name][leaf] for b in blocks])
                   for leaf in blocks[0][name]}
            for name in blocks[0]
        }
    else:
        tree.update({f"block_{i}": b for i, b in enumerate(blocks)})
    return tree
