"""The port's MoE layer against the reference's, on the olmoe smoke config.

Routing must agree exactly on expert ids (ties go to the lowest expert id
on both sides) with gates within 1e-6. The slot-buffer MoE output is bf16,
so it is held to 5e-2 against the reference's, on both expert paths.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as jax_smoke
from repro.models import moe as jax_moe
from repro_torch.bridge import to_tensor
from repro_torch.configs import get_smoke_config
from repro_torch.models import moe

CFG = get_smoke_config("olmoe-1b-7b")
M = CFG.moe


def _bf(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16))


def _moe_params(seed, d=CFG.d_model, E=M.num_experts, f=M.d_expert):
    rng = np.random.default_rng(seed)
    return {
        "router": (rng.standard_normal((d, E)) * d ** -0.5).astype(np.float32),
        "w_gate": _bf(rng.standard_normal((E, d, f)) * d ** -0.5),
        "w_up": _bf(rng.standard_normal((E, d, f)) * d ** -0.5),
        "w_down": _bf(rng.standard_normal((E, f, d)) * f ** -0.5),
    }


def _t(tree):
    return {k: to_tensor(v) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def test_configs_match_reference():
    from repro.configs.registry import get_config as jax_config
    from repro_torch.configs import get_config
    assert dataclasses.asdict(CFG) == dataclasses.asdict(jax_smoke("olmoe-1b-7b"))
    assert dataclasses.asdict(get_config("olmoe-1b-7b")) == \
        dataclasses.asdict(jax_config("olmoe-1b-7b"))


@pytest.mark.parametrize("norm", [False, True])
@pytest.mark.parametrize("tie", [False, True])
def test_route_matches_reference(norm, tie):
    rng = np.random.default_rng(1)
    p = _moe_params(2)
    router = p["router"]
    x = rng.standard_normal((16, CFG.d_model)).astype(np.float32)
    if tie:
        # experts 2 and 5 get identical router columns: equal logits
        router = router.copy()
        router[:, 5] = router[:, 2]
        router[:, 2] += 0.5 * x.mean(0) / np.linalg.norm(x.mean(0))
        router[:, 5] = router[:, 2]
    want = jax_moe.route(jnp.asarray(router), jnp.asarray(x), M.top_k, norm)
    got = moe.route(to_tensor(router), to_tensor(x), M.top_k, norm)
    ids = np.asarray(want.expert_ids)
    if tie:
        both = (ids == 2).any(1) & (ids == 5).any(1)
        assert both.any(), "the constructed tie never reached the top-k"
    np.testing.assert_array_equal(got.expert_ids.numpy(), ids)
    np.testing.assert_allclose(got.gates.numpy(), np.asarray(want.gates),
                               rtol=0, atol=1e-6)


def test_compute_dispatch_matches_reference():
    ids = np.random.default_rng(3).integers(0, M.num_experts, (12, M.top_k))
    want = jax_moe.compute_dispatch(jnp.asarray(ids, jnp.int32),
                                    M.num_experts, 3)
    got = moe.compute_dispatch(torch.as_tensor(ids), M.num_experts, 3)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("use_kernel", [False, True])
def test_moe_slotbuf_matches_reference(use_kernel):
    rng = np.random.default_rng(4)
    p = _moe_params(5)
    T, S = 10, 6
    x = _bf(rng.standard_normal((T, CFG.d_model)))
    # a slot buffer holding a permuted subset of the experts; the rest miss
    table = -np.ones(M.num_experts, np.int32)
    resident = rng.permutation(M.num_experts)[:S]
    table[resident] = rng.permutation(S)
    slots = {k: np.zeros((S,) + p[k].shape[1:], p[k].dtype)
             for k in ("w_gate", "w_up", "w_down")}
    for e in resident:
        for k in slots:
            slots[k][table[e]] = p[k][e]
    want, _ = jax_moe.moe_slotbuf(_j(p), _j(slots), jnp.asarray(table),
                                  jnp.asarray(x), M, capacity=T * M.top_k,
                                  use_kernel=use_kernel, interpret=True)
    got, _ = moe.moe_slotbuf(_t(p), _t(slots), to_tensor(table), to_tensor(x),
                             M, capacity=T * M.top_k, use_kernel=use_kernel)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=5e-2, atol=5e-2)


def test_moe_reference_and_grouped_match_reference():
    rng = np.random.default_rng(6)
    p = _moe_params(7)
    x = _bf(rng.standard_normal((9, CFG.d_model)))
    want, _ = jax_moe.moe_reference(_j(p), jnp.asarray(x), M)
    got, _ = moe.moe_reference(_t(p), to_tensor(x), M)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=5e-2, atol=5e-2)
    want_g, _ = jax_moe.moe_grouped(_j(p), jnp.asarray(x), M)
    got_g, _ = moe.moe_grouped(_t(p), to_tensor(x), M)
    np.testing.assert_allclose(got_g.float().numpy(),
                               np.asarray(want_g, np.float32),
                               rtol=5e-2, atol=5e-2)
