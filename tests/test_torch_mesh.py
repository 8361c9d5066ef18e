"""The port's mesh (`distributed/sharding.py`, `launch/mesh.py`, the EP MoE,
`distributed/pipeline.py`) on real CPU process groups (CPU).

Groups: gloo over a `FileStore` under the test's tmp_path (no TCP port, so
parallel test workers cannot collide): in this process for one rank,
spawned processes for 2 and 4.

- A (1, 1) mesh: the forward of yi-9b's and olmoe's smoke configs, params
  distributed with FSDP and tokens over ``data``, is bitwise the forward
  without a mesh (bf16, the port's own weights), and every olmoe MoE
  layer takes the expert-parallel path (`_can_shard_map`); on the
  reference's weights in float32 it is within 1e-4 of the JAX forward
  without a mesh (the reference's own mesh forward fails under JAX 0.9,
  see ROADMAP queue 3).
- Four spawned ranks, one group, three meshes:
  - (data 2, model 2): the EP MoE layer against `moe_grouped` on one
    device, float32 within 1e-5, with exactly one fp32 all-reduce over
    ``model`` of the rank's own groups and no all-gather of the tokens
    (so the expert-parallel path; the experts' weights already whole
    over ``data`` without FSDP), and with FSDP one all-gather over
    ``data`` per projection more; then two FSDP training steps (float32,
    olmoe smoke: data 2 with the experts and heads over model 2) against
    the same steps on one device, losses and weights within 1e-5; then,
    in float32 within 1e-5 of the same calls without a mesh, the forward
    and a prefill plus three decode steps of yi-9b's smoke config (one
    K/V head for four query heads: each rank's two query heads read a
    slice of the K/V heads, `_kv_slice`, and decode through
    `fused_decode_attention` on that slice) and of DeepSeek-V2-Lite's (MLA
    under tensor parallelism, shared experts, a dense first layer);
  - (data 4, model 1): the whole olmoe forward within 1e-5 of one
    device's;
  - (pod 2, data 2): `pipeline_stages` at 2 stages x 4 microbatches equal
    to the sequential stages, one collective permute a tick.
- One stage on a one-rank ``pod`` mesh is the stage function (the
  reference's `tests/test_distributed.py:69-82`).
- `bubble_fraction`, `make_production_mesh` refusing a small group, and
  `make_host_mesh` over the running group.
"""
import dataclasses
import traceback

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.configs import get_smoke_config
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.pipeline import (bubble_fraction,
                                              make_pipelined_forward,
                                              pipeline_stages)
from repro_torch.launch import hlo
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import moe as moe_mod
from repro_torch.models.transformer import Model
from repro_torch.tree import tree_leaves

TOL_F32 = 1e-5


@pytest.fixture
def one_rank(tmp_path):
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        yield make_host_mesh()
    finally:
        dist.destroy_process_group()


def _f32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


def _tokens(cfg, shape, seed=1):
    return torch.randint(0, cfg.vocab_size, shape,
                         generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("arch", ["yi-9b", "olmoe-1b-7b"])
def test_one_by_one_mesh_forward_bitwise(one_rank, arch, monkeypatch):
    mesh = one_rank
    cfg = get_smoke_config(arch)
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    toks = _tokens(cfg, (2, 8))
    want = model.forward(params, toks)
    taken = []
    can = moe_mod._can_shard_map
    monkeypatch.setattr(moe_mod, "_can_shard_map",
                        lambda *a: taken.append(can(*a)) or taken[-1])
    with shd.mesh_context(mesh, fsdp=True):
        got = model.forward(shd.distribute_params(params, mesh, fsdp=True),
                            shd.distribute(toks, ("data", None)))
    assert torch.equal(got.full_tensor(), want)
    assert taken == ([True] * cfg.num_layers if cfg.moe is not None else [])


@pytest.mark.parametrize("arch", ["yi-9b", "olmoe-1b-7b"])
def test_one_by_one_mesh_forward_matches_jax(one_rank, arch):
    import jax
    import jax.numpy as jnp

    from repro.configs.registry import get_smoke_config as jax_smoke
    from repro.models import Model as JaxModel
    from repro_torch.bridge import params_from_reference

    mesh = one_rank
    jcfg = _f32(jax_smoke(arch))
    jm = JaxModel(jcfg)
    jparams = jax.jit(jm.init)(jax.random.PRNGKey(0))
    toks = _tokens(jcfg, (2, 8))
    want = np.asarray(jm.forward(jparams, jnp.asarray(toks.numpy())))
    params = params_from_reference(jax.tree.map(np.asarray, jparams))
    with shd.mesh_context(mesh, fsdp=True):
        got = Model(_f32(get_smoke_config(arch))).forward(
            shd.distribute_params(params, mesh, fsdp=True),
            shd.distribute(toks, ("data", None)))
    np.testing.assert_allclose(got.full_tensor().numpy(), want, rtol=1e-4,
                               atol=1e-4)


# ---------------------------------------------------------------------------
# multi-rank: spawned gloo processes
# ---------------------------------------------------------------------------

def _worker(rank, world, store, case, q):
    try:
        dist.init_process_group("gloo", store=dist.FileStore(store, world),
                                rank=rank, world_size=world)
        q.put((rank, CASES[case]()))
    except Exception:  # noqa: BLE001 — reported to the test
        q.put((rank, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _spawn(tmp_path, world, case):
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_worker, args=(
        r, world, str(tmp_path / "store"), case, q)) for r in range(world)]
    for p in procs:
        p.start()
    try:
        out = dict(q.get(timeout=240) for _ in range(world))
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
    for r, res in out.items():
        assert not isinstance(res, str), f"rank {r}:\n{res}"
    return out


def _four_rank_case():
    from repro_torch.training.optimizer import adamw_init
    from repro_torch.training.steps import make_train_step
    res = {}
    mesh = make_host_mesh(model_parallel=2)
    cfg = _f32(get_smoke_config("olmoe-1b-7b"))
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    lp = params["layers"][0]["moe"]
    x = torch.randn(4, 8, cfg.d_model,
                    generator=torch.Generator().manual_seed(2))
    want, _ = moe_mod.moe_grouped(lp, x, cfg.moe)
    for fsdp in (False, True):
        with shd.mesh_context(mesh, fsdp=fsdp):
            pd = shd.distribute_params(params, mesh, fsdp=fsdp)
            xd = shd.distribute(x, ("data", None, None))
            with hlo.record() as rec:
                out, _ = moe_mod.moe_grouped(pd["layers"][0]["moe"], xd,
                                             cfg.moe)
            res[fsdp] = ((out.full_tensor() - want).abs().max().item(),
                         hlo.events_of(rec, "all-reduce"),
                         hlo.events_of(rec, "all-gather"))
    # FSDP training: the batch over data 2, the experts and heads over model
    toks = _tokens(cfg, (4, 9))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    step = make_train_step(model, remat=True, ce_chunk=16)
    p1, o1 = params, adamw_init(params)
    with shd.mesh_context(mesh, fsdp=True):
        pd = shd.distribute_params(params, mesh, fsdp=True)
        od = adamw_init(pd)
        bd = {k: shd.distribute(v, ("data", None)) for k, v in batch.items()}
        losses = []
        for _ in range(2):
            p1, o1, m1 = step(p1, o1, batch)
            pd, od, md = step(pd, od, bd)
            losses.append((float(m1["loss"]), float(md["loss"])))
        res["wdiff"] = max((a.full_tensor() - b).abs().max().item()
                           for a, b in zip(tree_leaves(pd), tree_leaves(p1)))
    res["losses"] = losses
    # the whole forward with the batch over data 4
    dmesh = init_device_mesh("cpu", (4, 1), mesh_dim_names=("data", "model"))
    with shd.mesh_context(dmesh, fsdp=True):
        got = model.forward(shd.distribute_params(params, dmesh, fsdp=True),
                            shd.distribute(toks, ("data", None)))
    res["forward"] = (got.full_tensor() - model.forward(params, toks)).abs() \
        .max().item()
    res["decode"] = {arch: _serve_on_mesh(arch, mesh)
                     for arch in ("yi-9b", "deepseek-v2-lite")}
    # pipeline: 2 stages x 4 microbatches over pod, the batch over data
    pmesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("pod", "data"))
    g = torch.Generator().manual_seed(3)
    W = torch.randn(2, 6, 6, generator=g) * 0.5
    x = torch.randn(4, 4, 6, generator=g)
    fwd = make_pipelined_forward(pmesh, lambda w, h: torch.tanh(h @ w[0]), 2,
                                 4)
    with hlo.record() as rec:
        y = fwd(shd.distribute(W, ("pod", None, None), pmesh),
                shd.distribute(x, (None, ("data",), None), pmesh))
    res["pipe"] = (y.full_tensor() - torch.tanh(torch.tanh(x @ W[0]) @ W[1])
                   ).abs().max().item()
    res["permutes"] = hlo.collective_stats(rec).count_by_kind.get(
        "collective-permute", 0)
    return res


def _serve_on_mesh(arch, mesh):
    """Max |meshed - unmeshed| of the forward, and of the logits of a
    prefill and three decode steps, in float32; the K/V heads each rank's
    attention reads and the (query, K/V) heads of every
    `fused_decode_attention` call in the meshed decode steps."""
    from repro_torch.models import transformer as tr
    cfg = _f32(get_smoke_config(arch))
    model = Model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    toks = _tokens(cfg, (4, 11))

    def serve(p, batch):
        logits, cache = model.prefill(p, batch(toks[:, :8]), max_seq=16)
        out = [logits]
        for i in range(8, 11):
            logits, cache = model.decode_step(p, batch(toks[:, i]), cache)
            out.append(logits)
        return out

    want_f, want_d = model.forward(params, toks), serve(params, lambda t: t)
    calls = []
    kernel = tr.fused_decode_attention

    def spy(q, k_new, *a, **kw):
        calls.append((q.shape[2], k_new.shape[2]))
        return kernel(q, k_new, *a, **kw)

    with shd.mesh_context(mesh, fsdp=True):
        pd = shd.distribute_params(params, mesh, fsdp=True)
        got_f = model.forward(pd, shd.distribute(toks, ("data", None)))
        tr.fused_decode_attention = spy
        try:
            got_d = serve(pd, lambda t: shd.distribute(
                t, ("data",) + (None,) * (t.dim() - 1)))
        finally:
            tr.fused_decode_attention = kernel
        kvs = tr._kv_slice(pd["layers"][0]["attn"])[1]
    return {"forward": (got_f.full_tensor() - want_f).abs().max().item(),
            "decode": max((g.full_tensor() - w).abs().max().item()
                          for g, w in zip(got_d, want_d)),
            "kv_slice": None if kvs is None else (kvs.start, kvs.stop),
            "kernel_heads": sorted(set(calls))}


CASES = {"four": _four_rank_case}


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    return _spawn(tmp_path_factory.mktemp("four"), 4, "four")


def test_ep_moe_on_2x2(four_ranks):
    cfg = get_smoke_config("olmoe-1b-7b")
    d, m = cfg.d_model, cfg.moe
    per_proj = (m.num_experts // 2) * d * m.d_expert * 4 // 2  # a data half
    for rank, res in four_ranks.items():
        for fsdp in (False, True):
            err, reduces, gathers = res[fsdp]
            assert err <= TOL_F32, (rank, fsdp, err)
            # one fp32 all-reduce of the (G_loc, Tg, d) output over model,
            # and the tokens not gathered: the expert-parallel path
            assert reduces == [(2 * 8 * d * 4, 2)], (rank, fsdp, reduces)
            assert gathers == ([(per_proj, 2)] * 3 if fsdp else []), \
                (rank, fsdp, gathers)


def test_fsdp_training_matches_one_device(four_ranks):
    for rank, res in four_ranks.items():
        for want, got in res["losses"]:
            assert abs(want - got) <= TOL_F32, (rank, res["losses"])
        assert res["wdiff"] <= TOL_F32, (rank, res["wdiff"])


def test_forward_with_the_batch_over_four_ranks(four_ranks):
    for rank, res in four_ranks.items():
        assert res["forward"] <= TOL_F32, (rank, res["forward"])


@pytest.mark.parametrize("arch", ["yi-9b", "deepseek-v2-lite"])
def test_serving_on_a_2x2_mesh_matches_one_device(four_ranks, arch):
    for rank, res in four_ranks.items():
        r = res["decode"][arch]
        assert r["forward"] <= TOL_F32, (rank, r)
        assert r["decode"] <= TOL_F32, (rank, r)
        if arch == "yi-9b":
            # 4 query heads over model 2, one K/V head: each rank reads it
            assert r["kv_slice"] == (0, 1), (rank, r)
            assert r["kernel_heads"] == [(2, 1)], (rank, r)
        else:
            assert r["kernel_heads"] == [], (rank, r)   # MLA: its own kernel


def test_two_stage_pipeline_matches_sequential_stages(four_ranks):
    for rank, res in four_ranks.items():
        assert res["pipe"] <= 1e-6, (rank, res["pipe"])
        assert res["permutes"] == 4 + 2 - 1


def test_pipeline_single_stage_is_the_stage(tmp_path):
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("pod",))
        pipelined = pipeline_stages(lambda p, x: x * p, n_stages=1,
                                    n_microbatches=3, axis_name="pod",
                                    mesh=mesh)
        x = torch.arange(6, dtype=torch.float32).reshape(3, 2)
        out = pipelined(torch.tensor(2.0), x)
        assert torch.equal(out, x * 2)
    finally:
        dist.destroy_process_group()


def test_bubble_fraction():
    assert bubble_fraction(1, 8) == 0.0
    assert bubble_fraction(4, 4) == pytest.approx(3 / 7)


def test_production_mesh_names_the_ranks_it_needs(one_rank):
    with pytest.raises(RuntimeError, match="256 ranks"):
        make_production_mesh()
    with pytest.raises(RuntimeError, match="512 ranks"):
        make_production_mesh(multi_pod=True)
    assert one_rank.mesh_dim_names == ("data", "model")
    assert tuple(one_rank.shape) == (1, 1)
