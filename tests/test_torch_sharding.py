"""The port's sharding rules (`distributed/sharding.py`) against the
reference's (CPU).

- `resolve_spec` and `_expand` equal to the reference's over a grid of
  specs and shapes (the reference's functions only read the mesh's axis
  names and sizes, so they take a stand-in with those), `constrain` a
  no-op without a mesh and on a plain tensor, and `batch_sharding` as the
  reference's `tests/test_distributed.py:19-44` sets out.
- `param_specs` leaf for leaf against the reference's on every registry
  smoke config, with and without FSDP: the reference's on its abstract
  params (`jax.eval_shape`), the stack dim it adds to scanned layers
  stripped and its layers unstacked as `bridge.unstack_layers` does; the
  port's on its own params (its layers are a list, so nothing is
  stacked).
- On a fake 16x16 mesh (the fake process group moves no data; shapes
  only), the local shard of every parameter of olmoe-1b-7b and
  qwen3-moe-235b-a22b at their published widths (initialised on the meta
  device, distributed as fake tensors) is its global shape cut by the
  resolved spec.
"""
import types

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.device_mesh import init_device_mesh
from torch.testing._internal.distributed.fake_pg import FakeStore

from repro.configs.registry import ARCH_IDS as JAX_ARCH_IDS
from repro.configs.registry import get_smoke_config as jax_smoke
from repro.distributed import sharding as jshd
from repro.models import Model as JaxModel
from repro_torch.bridge import unstack_layers
from repro_torch.configs.registry import ARCH_IDS, get_config, \
    get_smoke_config
from repro_torch.distributed import sharding as shd
from repro_torch.models.transformer import Model
from repro_torch.tree import leaves_with_paths, tree_map


@pytest.fixture(scope="module")
def mesh16():
    """A fake process group of 256 ranks (this process is rank 0) and the
    16x16 ("data", "model") mesh over it; closed after the module."""
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=256)
    try:
        yield init_device_mesh("cpu", (16, 16),
                               mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


def _stand_in(mesh):
    names = shd.axis_names(mesh)
    return types.SimpleNamespace(
        axis_names=names, shape={a: shd.axis_size(mesh, a) for a in names})


SPECS = [("model", None), ("data", "model"), (shd.BATCH, None),
         (("pod", "data"), None, "model"), (None, "pod"), ("data", None)]
SHAPES = [(7, 3), (32, 16), (16, 7, 48), (256, 33), (1, 16)]


def test_resolve_spec_matches_reference(mesh16):
    ref = _stand_in(mesh16)
    for spec in SPECS:
        for shape in SHAPES:
            if len(shape) < len(spec):
                continue
            want = tuple(jshd.resolve_spec(
                tuple(jshd.BATCH if e == shd.BATCH else e for e in spec),
                shape, ref))
            want = want + (None,) * (len(spec) - len(want))
            assert shd.resolve_spec(spec, shape, mesh16) == want, (spec,
                                                                   shape)
    # the reference's own case: a dim that does not divide drops its axis
    assert shd.resolve_spec(("model", None), (7, 3), mesh16) == (None, None)
    assert shd.resolve_spec(("model", None), (32, 3), mesh16) == \
        ("model", None)


def test_constrain_noop_without_mesh():
    shd.set_mesh(None)
    x = torch.ones(4, 4)
    assert shd.constrain(x, ("data", None)) is x
    with shd.mesh_context(object(), fsdp=True):
        assert shd.constrain(x, ("data", None)) is x   # a plain tensor
    assert shd.get_mesh() is None and not shd._ACTIVE["fsdp"]


def test_batch_sharding_and_placements(mesh16):
    bs = shd.batch_sharding(mesh16, 2, 0, 256)
    assert bs.spec == ("data", None)
    assert [type(p).__name__ for p in bs.placements] == ["Shard",
                                                         "Replicate"]
    assert shd.batch_sharding(mesh16, 2, 0, 1).spec == (None, None)
    assert shd.batch_sharding(mesh16, 3, 1).spec == (None, "data", None)
    assert shd.replicated(mesh16, 2).spec == (None, None)


def _ref_per_layer(tree, n_units: int, n_enc: int):
    """The reference's spec tree with stacked leaves un-stacked: each
    stacked leaf (leading None) becomes one entry per repeat, as
    `bridge.unstack_layers` slices arrays."""
    def strip(t, n):
        if isinstance(t, dict):
            return {k: strip(v, n) for k, v in t.items()}
        arr = np.empty(n, dtype=object)
        for i in range(n):
            arr[i] = tuple(t[1:])
        return arr

    out = {k: tuple(tree[k]) for k in ("embed", "final_norm", "lm_head")
           if k in tree}
    layers = unstack_layers({
        "prefix": tree.get("prefix", []),
        "unit": [strip(u, n_units) for u in tree.get("unit", [])],
        "tail": tree.get("tail", [])})
    out["layers"] = [_tuples(lp) for lp in layers]
    if "encoder" in tree:
        enc = strip(tree["encoder"]["layers"], n_enc)
        out["encoder"] = {"layers": [_tuples(_take(enc, i))
                                     for i in range(n_enc)],
                          "final_norm": tuple(tree["encoder"]["final_norm"])}
    return out


def _spec_leaves(tree, prefix=""):
    """[(path, spec)] of a spec tree: dicts and lists are nodes, a spec
    (a tuple) is a leaf."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _spec_leaves(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, list):
        return [x for i, t in enumerate(tree)
                for x in _spec_leaves(t, f"{prefix}/{i}")]
    return [(prefix, tree)]


def _take(tree, i):
    if isinstance(tree, dict):
        return {k: _take(v, i) for k, v in tree.items()}
    return tree[i]


def _tuples(tree):
    if isinstance(tree, dict):
        return {k: _tuples(v) for k, v in tree.items()}
    return tuple(tree)


@pytest.mark.parametrize("name", sorted(ARCH_IDS))
def test_param_specs_match_reference(name):
    assert name in JAX_ARCH_IDS
    jcfg = jax_smoke(name)
    shapes = jax.eval_shape(JaxModel(jcfg).init, jax.random.PRNGKey(0))
    n_units = int(jax.tree.leaves(shapes["unit"][0])[0].shape[0]) \
        if shapes.get("unit") else 0
    params = Model(get_smoke_config(name)).init(
        torch.Generator().manual_seed(0), device="cpu")
    for fsdp in (False, True):
        want = _ref_per_layer(jshd.param_specs(shapes, fsdp=fsdp), n_units,
                              jcfg.encoder_layers)
        got = _spec_leaves(shd.param_specs(params, fsdp=fsdp))
        assert [k for k, _ in got] == [k for k, _ in _spec_leaves(want)]
        for (k, a), (_, b) in zip(got, _spec_leaves(want)):
            assert a == b, (name, fsdp, k)


@pytest.mark.parametrize("name", ["olmoe-1b-7b", "qwen3-moe-235b-a22b"])
def test_local_shards_on_fake_16x16(mesh16, name):
    cfg = get_config(name)
    params = Model(cfg).init(device="meta")
    with FakeTensorMode():
        dp = shd.distribute_params(
            tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype), params),
            mesh16, fsdp=True)
    specs = shd.param_specs(params, fsdp=True)
    n_sharded = 0
    for (path, t), (_, spec) in zip(leaves_with_paths(dp),
                                    _spec_leaves(specs)):
        r = shd.resolve_spec(spec, tuple(t.shape), mesh16)
        want = tuple(d // shd._axis_size(mesh16, e)
                     for d, e in zip(t.shape, r))
        assert tuple(t.to_local().shape) == want, (path, r)
        n_sharded += any(e is not None for e in r)
    assert n_sharded > len(params["layers"])   # at least a weight a layer
    emb = dp["embed"]
    assert tuple(emb.to_local().shape) == (cfg.vocab_size // 16,
                                           cfg.d_model // 16)
