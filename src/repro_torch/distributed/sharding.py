"""Sharding rules: logical axes -> mesh axes, param specs, activation hints,
over DTensor (`torch.distributed.tensor`) on a named `DeviceMesh`.

Axes:
- ``model``  tensor-parallel (attention heads, FFN hidden) AND expert-parallel
             (MoE expert dim) — one physical axis, two logical roles.
- ``data``   batch sharding; in training additionally FSDP: parameters and
             optimizer state sharded over ``data`` and all-gathered per use.
- ``pod``    multi-pod replica axis (pure DP; gradient all-reduce crosses it).

A spec is a tuple with one entry per tensor dim: None, a mesh axis name, a
tuple of names, or `BATCH` (("pod", "data") ∩ the mesh's axes). It plays
the role of the reference's `PartitionSpec`; `placements` turns a resolved
spec into DTensor placements (one per mesh dim, in the mesh's order, so
("pod", "data") on one tensor dim shards pod-major).

`constrain` is a safe redistribute: it returns its input unchanged unless a
mesh context is active and the input is a DTensor, silently drops axes
absent from the mesh, and drops assignments that do not divide the
dimension (e.g. batch=1 long-context decode cannot shard over ``data``).

Where the model's arithmetic has no sharding rule (the reference leaves it
to GSPMD's propagation), it runs as a *region* (`region`): each DTensor
argument's local shard goes through the plain function, and the outputs
come back as DTensors with the placements the caller names. A region whose
weights are sharded over ``model`` (attention heads, FFN hidden, experts)
returns partial sums over ``model``, which `region` all-reduces (the
redistribute of a ``Partial`` placement); a region that cannot take the
``model`` sharding gathers its operands first (``tp=False``). Importing
this module touches no device and no process group.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, List, NamedTuple, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)

from repro_torch.tree import leaves_with_paths

_ACTIVE: dict = {"mesh": None, "fsdp": False}

BATCH = "__batch__"   # symbolic: expands to ("pod", "data") ∩ mesh axes


def set_mesh(mesh, fsdp: bool = False) -> None:
    _ACTIVE["mesh"] = mesh
    _ACTIVE["fsdp"] = fsdp


def get_mesh():
    return _ACTIVE["mesh"]


@contextlib.contextmanager
def mesh_context(mesh, fsdp: bool = False):
    prev = dict(_ACTIVE)
    set_mesh(mesh, fsdp)
    try:
        yield
    finally:
        _ACTIVE.update(prev)


def axis_names(mesh) -> Tuple[str, ...]:
    return tuple(mesh.mesh_dim_names or ())


def axis_size(mesh, name: str) -> int:
    """Size of one named mesh axis (1 when the mesh lacks it)."""
    names = axis_names(mesh)
    return mesh.size(names.index(name)) if name in names else 1


def batch_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in axis_names(mesh))


def _expand(entry, mesh):
    """Translate a symbolic spec entry to concrete mesh axes (or None)."""
    if entry is None:
        return None
    names = axis_names(mesh)
    if entry == BATCH or entry == "data":
        axes = batch_axes(mesh)
        return axes if axes else None
    if isinstance(entry, (tuple, list)):
        axes = tuple(a for a in entry if a in names)
        return axes if axes else None
    return entry if entry in names else None


def _axis_size(mesh, entry) -> int:
    if entry is None:
        return 1
    if isinstance(entry, tuple):
        n = 1
        for a in entry:
            n *= axis_size(mesh, a)
        return n
    return axis_size(mesh, entry)


def _one(entry):
    """A one-axis tuple as its name (as a `PartitionSpec` prints it)."""
    return entry[0] if isinstance(entry, tuple) and len(entry) == 1 \
        else entry


def resolve_spec(spec: Sequence, shape: Tuple[int, ...], mesh) -> Tuple:
    """Concrete spec (one entry per dim) with divisibility guards."""
    out = []
    for dim, entry in zip(shape, spec):
        e = _expand(entry, mesh)
        if e is not None and dim % _axis_size(mesh, e) != 0:
            e = None
        out.append(_one(e))
    return tuple(out)


def placements(spec: Sequence, mesh) -> List:
    """DTensor placements of a resolved spec: Shard(i) on each mesh axis
    named in entry i, Replicate on the others."""
    out: List = [Replicate()] * len(axis_names(mesh))
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            out[axis_names(mesh).index(a)] = Shard(i)
    return out


def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


def constrain(x, spec: Sequence):
    """Safe redistribute (no-op without an active mesh or on a plain
    tensor, such as a region's local shard)."""
    mesh = _ACTIVE["mesh"]
    if mesh is None or not isinstance(x, DTensor):
        return x
    want = placements(resolve_spec(spec, tuple(x.shape), mesh), mesh)
    if list(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


def distribute(x: torch.Tensor, spec: Sequence, mesh=None):
    """A plain tensor that every rank holds whole, as a DTensor of `spec`
    on `mesh` (default: the active one): each rank keeps its own shard, no
    data moves. Without a mesh, x itself."""
    mesh = _ACTIVE["mesh"] if mesh is None else mesh
    if mesh is None or isinstance(x, DTensor):
        return x
    pl = placements(resolve_spec(spec, tuple(x.shape), mesh), mesh)
    return distribute_tensor(x, mesh, pl, src_data_rank=None)


def replicate_like(x: torch.Tensor, ref):
    """A plain tensor every rank holds alike, as a replicated DTensor on
    `ref`'s mesh when `ref` is a DTensor (so the two can meet in one op);
    otherwise x itself."""
    if not isinstance(ref, DTensor) or isinstance(x, DTensor):
        return x
    mesh = ref.device_mesh
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


# ---------------------------------------------------------------------------
# Parameter sharding rules (name-based)
# ---------------------------------------------------------------------------

def _param_spec(path: Tuple[str, ...], shape: Tuple[int, ...],
                fsdp: bool) -> Sequence:
    """Symbolic spec for a parameter, given its key path and *logical* shape
    (leading stack dims already stripped)."""
    name = path[-1]
    parent = path[-2] if len(path) >= 2 else ""
    d = "data" if fsdp else None

    if name == "embed":
        return ("model", d)
    if name == "lm_head":
        return (d, "model")
    if name in ("wq", "wq_b"):                       # (d|r, H, hd)
        return (d, "model", None)
    if name in ("wk", "wv"):                         # (d, Hkv, hd)
        return (d, "model", None)
    if name == "wo":                                 # (H, hd, d)
        return ("model", None, d)
    if name in ("wq_a", "wkv_a"):                    # (d, r)
        return (d, None)
    if name == "wkv_b":                              # (r, H, hd)
        return (None, "model", None)
    if name == "router":                             # (d, E) — small, replicated
        return (None, None)
    if parent == "moe" and name in ("w_gate", "w_up"):   # (E, d, f)
        return ("model", d, None)
    if parent == "moe" and name == "w_down":             # (E, f, d)
        return ("model", None, d)
    if name in ("w_gate", "w_up"):                   # dense ffn (d, ff)
        return (d, "model")
    if name == "w_down":                             # (ff, d)
        return ("model", d)
    # recurrent / xlstm
    if name in ("w_x",):                             # (d, w)
        return (d, "model")
    if name == "conv_w":                             # (K, w)
        return (None, "model")
    if name in ("w_input_gate", "w_rec_gate"):       # (w, w)
        return ("model", None)
    if name == "w_out":                              # (w, d)
        return ("model", d)
    if name in ("w_q", "w_k", "w_v", "w_z", "w_o"):  # (up, up)
        return (d, "model")
    if name == "w_i" or name == "w_f":               # (up, H)
        return (None, None)
    if name == "r_z":                                # (H, hd, hd)
        return (None, None, None)
    # norms, biases, scalars
    return tuple(None for _ in shape)


def _path_keys(path: str) -> Tuple[str, ...]:
    """'layers/0/attn/wq' -> ('layers', '[0]', 'attn', 'wq')."""
    return tuple(f"[{k}]" if k.isdigit() else k.lstrip(".")
                 for k in path.split("/") if k)


def _is_stacked(keys: Tuple[str, ...]) -> bool:
    """A leaf stacked over layers: under a 'unit' or 'layers' node with no
    list index after it (the reference's scanned trees). The port keeps its
    layers (and the encoder's) as lists, so none of its leaves is."""
    for i, k in enumerate(keys):
        if k in ("unit", "layers") and not (
                i + 1 < len(keys) and keys[i + 1].startswith("[")):
            return True
    return False


def _spec_of(keys: Tuple[str, ...], shape: Tuple[int, ...],
             fsdp: bool) -> Tuple:
    stacked = _is_stacked(keys)
    logical = shape[1:] if stacked and len(shape) >= 1 else shape
    spec = _param_spec(tuple(k for k in keys if not k.startswith("[")),
                       logical, fsdp)
    if stacked:
        spec = (None,) + tuple(spec)
    # pad/trim to rank
    spec = tuple(spec)[:len(shape)]
    return spec + (None,) * (len(shape) - len(spec))


def _map_with_path(fn: Callable, tree, prefix: str = ""):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, f"{prefix}/{k}") for k, v in
                tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "shape"):
        out = [_map_with_path(fn, v, f"{prefix}/{i}")
               for i, v in enumerate(tree)]
        return type(tree)(out) if not hasattr(tree, "_fields") \
            else type(tree)(*out)
    return fn(prefix, tree)


def param_specs(params: Any, fsdp: bool = False) -> Any:
    """Tree of symbolic specs matching `params` structure."""
    return _map_with_path(
        lambda path, leaf: _spec_of(_path_keys(path),
                                    tuple(getattr(leaf, "shape", ())), fsdp),
        params)


def _is_routed_expert(keys: Tuple[str, ...]) -> bool:
    return ("moe" in keys and keys[-1] in ("w_gate", "w_up", "w_down")
            and "shared" not in keys)


def gather_for_compute(layer_params: Any) -> Any:
    """FSDP weight-gathering: constrain each weight to its non-FSDP spec
    (model-axis only) right before use, so the collective is one
    weight-sized all-gather per layer (storage stays sharded; the
    gradients reduce-scatter back through the redistribute's backward)
    instead of an activation-sized all-reduce per matmul.

    No-op when no mesh context is active, and for weights not stored
    FSDP-sharded (the regions that compute with them take whole rows over
    the batch axes, so weights stored sharded over ``data`` are gathered
    here even when training is not on: serving with FSDP storage).
    """
    if _ACTIVE["mesh"] is None:
        return layer_params

    def one(path, x):
        keys = _path_keys(path)
        # routed expert weights enter the EP layer with their stored FSDP
        # sharding (gathered there, over 'data' only)
        if _is_routed_expert(keys) or not hasattr(x, "shape"):
            return x
        return constrain(x, _spec_of(keys, tuple(x.shape), False))

    return _map_with_path(one, layer_params)


class Sharding(NamedTuple):
    """A tensor's layout on a mesh: the resolved spec and its placements
    (the reference's `NamedSharding`)."""
    mesh: Any
    spec: Tuple
    placements: List


def sharding_of(mesh, spec: Sequence, shape: Tuple[int, ...]) -> Sharding:
    r = resolve_spec(spec, shape, mesh)
    return Sharding(mesh, r, placements(r, mesh))


def param_shardings(params: Any, mesh, fsdp: bool = False) -> Any:
    """Tree of `Sharding`s for `params` (tensors or anything with .shape)."""
    return _map_with_path(
        lambda path, leaf: sharding_of(
            mesh, _spec_of(_path_keys(path), tuple(leaf.shape), fsdp),
            tuple(leaf.shape)), params)


def distribute_params(params: Any, mesh, fsdp: bool = False) -> Any:
    """The params as DTensors laid out by `param_shardings` (the reference's
    `jax.device_put(params, shardings)`). Every rank must hold the same
    full params: each keeps its own shards, no data moves."""
    return _map_with_path(
        lambda path, t: distribute_tensor(
            t, mesh, sharding_of(mesh, _spec_of(_path_keys(path),
                                                tuple(t.shape), fsdp),
                                 tuple(t.shape)).placements,
            src_data_rank=None), params)


def replicated(mesh, rank: int = 0) -> Sharding:
    return Sharding(mesh, (None,) * rank, [Replicate()] * mesh.ndim)


def batch_sharding(mesh, rank: int, batch_dim: int = 0,
                   batch_size: Optional[int] = None) -> Sharding:
    spec: list = [None] * rank
    axes = batch_axes(mesh)
    if axes:
        n = 1
        for a in axes:
            n *= axis_size(mesh, a)
        if batch_size is None or batch_size % n == 0:
            spec[batch_dim] = _one(axes)
    return Sharding(mesh, tuple(spec), placements(spec, mesh))


# ---------------------------------------------------------------------------
# Regions: plain code on local shards
# ---------------------------------------------------------------------------

def model_rank(mesh) -> int:
    """This rank's coordinate on the ``model`` axis (0 without one)."""
    if "model" not in axis_names(mesh):
        return 0
    return mesh.get_local_rank("model")


def model_dim(x) -> Optional[int]:
    """The tensor dim a DTensor shards over ``model``, else None."""
    if not isinstance(x, DTensor):
        return None
    names = axis_names(x.device_mesh)
    if "model" not in names:
        return None
    p = x.placements[names.index("model")]
    return p.dim if isinstance(p, Shard) else None


def _leaves(tree) -> List:
    return [x for _, x in leaves_with_paths(tree)]


def _gather_model(x):
    """x with its ``model`` sharding (if any) gathered."""
    if model_dim(x) is None:
        return x
    mesh = x.device_mesh
    pl = list(x.placements)
    pl[axis_names(mesh).index("model")] = Replicate()
    return x.redistribute(mesh, pl)


class Out(NamedTuple):
    """How a region's output comes back: `spec` one entry per dim (None,
    an axis name or a tuple of them, or `BATCH` for the batch axes the
    region's activation is sharded on); `partial` a partial sum to
    all-reduce over ``model`` (True) or over the named axis."""
    spec: Tuple
    partial: Any = False


def region(fn: Callable, *args, like, out: Any, tp: bool = True):
    """Run `fn` on the local shards of `args` (DTensors anywhere in nested
    dicts / lists / tuples; anything else passes through) and return its
    outputs as DTensors on the active mesh.

    `like`: the region's activation (a DTensor whose dim 0 is the batch):
    `BATCH` in an output spec means the mesh axes its batch is sharded on.
    `out`: an `Out` for each output (a tree like fn's result, or one `Out`
    for every tensor in it; None passes an output through). `tp=False`
    first gathers every argument's ``model`` sharding, so fn sees whole
    weights over ``model`` (the fallback for arithmetic with no
    tensor-parallel rule here).

    Gradients: a replicated input that meets a sharded one (the batch over
    the data axes, heads or experts over ``model``) gets a partial
    gradient over those axes; the redistributes of the backward pass sum
    it."""
    mesh = _ACTIVE["mesh"]
    names = axis_names(mesh)
    if not tp:
        args = tuple(_map_with_path(
            lambda _, a: _gather_model(a) if isinstance(a, DTensor) else a,
            arg) for arg in args)
    varying = set()
    for a in _leaves(args):
        if isinstance(a, DTensor):
            varying |= {i for i, p in enumerate(a.placements)
                        if isinstance(p, Shard)}
    batch_dims = _batch_dims(like)

    def local(_, a):
        if not isinstance(a, DTensor):
            return a
        gp = [Partial() if (i in varying and isinstance(p, Replicate))
              else p for i, p in enumerate(a.placements)]
        return a.to_local(grad_placements=gp)

    res = fn(*(_map_with_path(local, a) for a in args))

    def wrap(o, o_out: Optional[Out]):
        if o_out is None or not isinstance(o, torch.Tensor):
            return o
        pl = _out_placements(o_out.spec, mesh, batch_dims)
        axis = "model" if o_out.partial is True else o_out.partial
        if axis and axis in names:
            pl[names.index(axis)] = Partial()
        t = DTensor.from_local(o, mesh, pl, run_check=False)
        if axis and axis in names:
            pl[names.index(axis)] = Replicate()
            t = t.redistribute(mesh, pl)
        return t

    return _zip_map(wrap, res, out)


def _batch_dims(like) -> List[int]:
    """The mesh dims a DTensor shards its dim 0 (the batch) over."""
    return [i for i, p in enumerate(like.placements)
            if isinstance(p, Shard) and p.dim == 0]


def _out_placements(spec: Sequence, mesh, batch_dims: List[int]) -> List:
    """Placements of an output spec: `BATCH` shards over `batch_dims`, an
    axis name (or a tuple of them) over those axes; the rest replicate."""
    names = axis_names(mesh)
    pl: List = [Replicate()] * len(names)
    for d, e in enumerate(spec):
        if e == BATCH:
            for i in batch_dims:
                pl[i] = Shard(d)
        elif e is not None:
            for a in (e if isinstance(e, tuple) else (e,)):
                pl[names.index(a)] = Shard(d)
    return pl


def relayout(x, spec: Sequence, like):
    """x (a DTensor) redistributed to `spec` (`BATCH` as in `region`: the
    batch axes `like` shards its dim 0 on); a plain x passes through."""
    if not isinstance(x, DTensor):
        return x
    want = _out_placements(spec, x.device_mesh, _batch_dims(like))
    if list(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def batch_like(t, like):
    """t (a plain tensor every rank holds whole, or a DTensor), whose dim 0
    is `like`'s batch, laid out over the batch axes as `like` is (no data
    moves for a plain t)."""
    if not isinstance(t, DTensor):
        mesh = like.device_mesh
        t = DTensor.from_local(t.contiguous(), mesh,
                               [Replicate()] * mesh.ndim, run_check=False)
    return relayout(t, (BATCH,), like)


def spec_of(x) -> Tuple:
    """The output spec that reproduces a DTensor's placements."""
    names = axis_names(x.device_mesh)
    spec: List = [()] * x.dim()
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard):
            spec[p.dim] = spec[p.dim] + (names[i],)
    return tuple(e if e else None for e in spec)


def _zip_map(fn, res, spec):
    """fn over the leaves of `res`, each with its `Out` from `spec` (a tree
    of the same structure, or one `Out` / None for a whole subtree)."""
    if spec is None or isinstance(spec, Out):
        if isinstance(res, dict):
            return {k: _zip_map(fn, v, spec) for k, v in res.items()}
        if isinstance(res, (list, tuple)):
            out = [_zip_map(fn, r, spec) for r in res]
            return type(res)(*out) if hasattr(res, "_fields") \
                else type(res)(out)
        return fn(res, spec)
    if isinstance(res, dict):
        return {k: _zip_map(fn, v, spec[k]) for k, v in res.items()}
    out = [_zip_map(fn, r, sp) for r, sp in zip(res, spec)]
    return type(res)(*out) if hasattr(res, "_fields") else type(res)(out)
