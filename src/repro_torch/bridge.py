"""Parameter bridge: the reference package's parameter tree -> the port's.

The input is the reference tree with every leaf already a numpy array
(``embed``, ``lm_head`` unless the embeddings are tied, ``final_norm``,
the ``prefix``/``tail`` lists of per-layer dicts and the ``unit`` list of
per-pattern-position dicts whose leaves are stacked over unit repeats; a
gemma2 layer's dict carries its post-norms, an MLA layer's its latent
projections; an encoder-decoder's ``encoder`` holds ``layers``, stacked
over its depth, and ``final_norm``). The output is the port's flat tree
(``{"embed", "final_norm", ["lm_head"], "layers": [...], ["encoder":
{"layers": [...], "final_norm"}]}``) of torch tensors, each layer dict
with the reference's keys.

bfloat16 leaves move bitwise through a ``uint16`` view; other dtypes are
copied as they are (the fp32 leaves of a bf16 model, such as the
recurrent mixers' gate weights, stay fp32). Nothing here knows about the framework that made the
arrays.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch


def to_tensor(a: np.ndarray, device="cpu") -> torch.Tensor:
    """numpy -> torch, bitwise; bfloat16 arrays go through a uint16 view."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    return t.to(device)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _unit_layer(unit_tree, u: int):
    """Slice repeat `u` out of a stacked unit subtree."""
    return _map(unit_tree, lambda a: a[u])


def unstack_layers(tree: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Per-absolute-layer dicts in depth order: prefix, then the unit
    pattern repeated (repeat-major, as the reference's `_layer_params`
    indexes it), then tail."""
    layers = list(tree.get("prefix", []))
    unit = tree.get("unit", [])
    if unit:
        n_units = int(np.shape(next(_leaves(unit[0])))[0])
        for u in range(n_units):
            layers.extend(_unit_layer(pos, u) for pos in unit)
    layers.extend(tree.get("tail", []))
    return layers


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def params_from_reference(tree: Dict[str, Any], device="cpu"
                          ) -> Dict[str, Any]:
    """The port's param tree from a numpy copy of the reference's."""
    conv = lambda a: to_tensor(a, device)  # noqa: E731
    out: Dict[str, Any] = {k: conv(tree[k])
                           for k in ("embed", "final_norm", "lm_head")
                           if k in tree}
    out["layers"] = [_map(p, conv) for p in unstack_layers(tree)]
    if "encoder" in tree:
        enc = tree["encoder"]
        n = int(np.shape(next(_leaves(enc["layers"])))[0])
        out["encoder"] = {
            "layers": [_map(_unit_layer(enc["layers"], i), conv)
                       for i in range(n)],
            "final_norm": conv(enc["final_norm"])}
    return out
