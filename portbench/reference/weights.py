"""The benchmark's seeded weight maker, shared by the served side and the
plain reference.

Weights are a pure function of (seed, leaf path, shape, dtype): each group
of leaves (one model's top-level tensors; per layer its attention and
norms, its routed experts, its router) is drawn in one call from a
generator seeded with a hash of (seed, group), on the device, in the
dtype the leaf is served in, then scaled leaf by leaf. So the reference
can draw any one layer again after the program's run, bit for bit, without
holding the model. Nothing here imports the program.

Laws, by leaf: the embedding N(0, 1); a norm scale 1 + 0.05 N(0, 1) (so a
program that skips a norm's weight parts from the reference); a routed
expert's (E, a, b) matrices N(0, 1 / a); an attention output projection
(H, D, d) N(0, 1 / (H D)); every other matrix N(0, 1 / its first
dimension). The matrices that write into the residual stream (`wo`, every
`w_down`) are then scaled by 1 / sqrt(2 L) for a model of L layers, GPT-2's
rule for its 2 L residual branches (Radford et al. 2019, section 2.3): the
branches together add about as much as the embedding, so the next token
still depends on the current one. Without it the 2 L unit-sized branches
swamp the embedding, the hidden state varies little from step to step, and
greedy decoding of the random model repeats a few tokens (69-98 % of an
olmoe request's tokens at 16 layers), which keeps one set of experts
resident and makes a request's speed a matter of its seed.
"""
from __future__ import annotations

import hashlib
from typing import Dict, Iterable, List, Sequence, Tuple

import torch

Leaf = Tuple[str, Tuple[int, ...], torch.dtype]

_EXPERT_LEAVES = ("w_gate", "w_up", "w_down")


def group_of(path: str) -> str:
    """The draw a leaf belongs to: "top" for the model's own tensors,
    "layers.<i>.experts" / ".router" / ".rest" for a layer's."""
    parts = path.split(".")
    if parts[0] != "layers":
        return "top"
    base = ".".join(parts[:2])
    if parts[2] == "moe" and parts[3] in _EXPERT_LEAVES:
        return base + ".experts"
    if parts[2] == "moe" and parts[3] == "router":
        return base + ".router"
    return base + ".rest"


def group_seed(seed: int, group: str) -> int:
    digest = hashlib.sha256(f"{int(seed)}/{group}".encode()).hexdigest()
    return int(digest[:15], 16)


def _std(path: str, shape: Sequence[int], depth: int) -> float:
    name = path.split(".")[-1]
    if path == "embed":
        return 1.0
    if ".moe." in path and ".shared." not in path and name in _EXPERT_LEAVES:
        std = float(shape[1]) ** -0.5
    elif name == "wo":
        std = float(shape[0] * shape[1]) ** -0.5
    else:
        std = float(shape[0]) ** -0.5
    if name in ("wo", "w_down"):
        std *= (2.0 * depth) ** -0.5
    return std


def depth_of(layout: Iterable[Leaf]) -> int:
    """The number of layers a layout holds."""
    return 1 + max(int(p.split(".")[1]) for p, _, _ in layout
                   if p.startswith("layers."))


def make_group(seed: int, group: str, leaves: Iterable[Leaf], device,
               depth: int) -> Dict[str, torch.Tensor]:
    """Draw every leaf of one group of a model of `depth` layers: one
    `randn` per dtype over the group's leaves in path order, carved into
    the leaves and scaled. Each leaf is a tensor of its own, not a view of
    the draw, so freeing one frees its memory."""
    leaves = sorted(leaves, key=lambda l: l[0])
    out: Dict[str, torch.Tensor] = {}
    gen = torch.Generator(device=device)
    gen.manual_seed(group_seed(seed, group))
    dtypes: List[torch.dtype] = []
    for _, _, dt in leaves:
        if dt not in dtypes:
            dtypes.append(dt)
    for dt in dtypes:
        mine = [l for l in leaves if l[2] == dt]
        total = sum(_numel(s) for _, s, _ in mine)
        flat = torch.randn(total, generator=gen, dtype=dt, device=device)
        off = 0
        for path, shape, _ in mine:
            n = _numel(shape)
            x = flat[off:off + n].view(shape)
            off += n
            if len(shape) == 1:
                x = x * 0.05 + 1.0
            else:
                x = x * _std(path, shape, depth)
            out[path] = x          # arithmetic made a tensor of its own
        del flat
    return out


def _numel(shape: Sequence[int]) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def groups(layout: Iterable[Leaf]) -> Dict[str, List[Leaf]]:
    """The layout's leaves by group, in a fixed order."""
    out: Dict[str, List[Leaf]] = {}
    for leaf in layout:
        out.setdefault(group_of(leaf[0]), []).append(leaf)
    return out


def make_all(seed: int, layout: Iterable[Leaf],
             device) -> Dict[str, torch.Tensor]:
    """Every leaf of a layout, {path: tensor}."""
    layout = list(layout)
    depth = depth_of(layout)
    out: Dict[str, torch.Tensor] = {}
    for g, leaves in groups(layout).items():
        out.update(make_group(seed, g, leaves, device, depth))
    return out
