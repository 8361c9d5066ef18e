"""Expert integrity in the port against the reference (CPU).

- `IntegrityGuard`: modes, transitions and counters equal the reference's
  over seeded sequences.
- The port's `TieredExpertStore` and the reference's over the same shards,
  under `FaultPlan.corrupt_flaky(0)` (verify ``scrub``) and
  `corrupt_disk(0)` (verify ``promote``), driven by the same seeded calls:
  equal snapshots, integrity counters, quarantined sets and open episodes
  after every call, the episode invariant, and every host-resident record
  holds its shard's bytes (its CRC, and the reference's host copy bit for
  bit): no corrupt record lands, with records read ahead of demands or
  not.
- Served under each plan on olmoe and DeepSeek smoke, both decode paths:
  every request emits its budget, and every occupied device slot holds
  its shard record's bytes at the end; on olmoe smoke also against the
  JAX engine, counter for counter (`test_torch_expert_tiers`).
"""
import zlib

import numpy as np
import pytest

from repro.core import expert_tiers as ref_tiers
from repro.core import faults as jax_faults
from repro.core import integrity as ref_integrity
from repro_torch.core.expert_tiers import TieredExpertStore
from repro_torch.core.faults import FaultInjector, FaultPlan
from repro_torch.core.integrity import VERIFY_MODES, IntegrityGuard
from repro_torch.models.transformer import Model
from repro_torch.runtime.engine import SlotBufferEngine
from repro_torch.runtime.request import Request
from repro_torch.runtime.serving import EngineServingConfig, ServingEngine
from test_torch_expert_tiers import (ARCHS, PATHS, _bits, _half, _no_experts,
                                     serve_against_jax)
from test_torch_expert_tiers import shards, smokes  # noqa: F401 (fixtures)

PLANS = {"corrupt_flaky": "scrub", "corrupt_disk": "promote"}


def _guard_state(g):
    return (g.mode, sorted(g.quarantined), dict(g.healing), g.counters(),
            g.n_episodes, g.n_quarantine_denials, g.enabled,
            g.scrub_enabled)


@pytest.mark.parametrize("mode", VERIFY_MODES)
def test_guard_modes_equal_the_reference(mode):
    assert _guard_state(IntegrityGuard(mode, scrub_budget=3)) == \
        _guard_state(ref_integrity.IntegrityGuard(mode, scrub_budget=3))
    with pytest.raises(ValueError, match="verify mode"):
        IntegrityGuard("sometimes")


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_guard_transitions_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    mine = IntegrityGuard("scrub", refetch_max=2)
    ref = ref_integrity.IntegrityGuard("scrub", refetch_max=2)
    for step in range(300):
        op = int(rng.choice(4, p=[0.4, 0.3, 0.1, 0.2]))
        key = (int(rng.integers(3)), int(rng.integers(6)))
        outs = []
        for g in (mine, ref):
            if g.is_quarantined(key):  # the tier never re-verifies these
                outs.append(g.is_quarantined(key))
            elif op == 0:
                outs.append(g.record_corrupt(key))
            elif op == 1:
                outs.append(g.record_clean(key))
            elif op == 2:             # as the tier does: an open episode
                outs.append(g.quarantine(key) if key in g.healing else None)
            else:
                outs.append(g.is_quarantined(key))
        assert outs[0] == outs[1], (step, op, key)
        assert _guard_state(mine) == _guard_state(ref), (step, op, key)
    for g in (mine, ref):
        assert g.n_episodes == g.n_requarantined + len(g.quarantined) \
            + len(g.healing)


def _stores(sdir, plan, seed=0):
    verify = PLANS[plan]
    budget = _half(sdir)
    mine = TieredExpertStore(sdir, host_budget_bytes=budget, verify=verify)
    ref = ref_tiers.TieredExpertStore(sdir, host_budget_bytes=budget,
                                      verify=verify)
    mine.set_faults(FaultInjector(getattr(FaultPlan, plan)(seed=seed)),
                    retry_max=2)
    ref.set_faults(jax_faults.FaultInjector(
        getattr(jax_faults.FaultPlan, plan)(seed=seed)), retry_max=2)
    mine.attach(n_pins=4)
    return mine, ref


def _no_corrupt_resident(mine, ref):
    for key in list(mine._host):
        li, e = key
        crc = 0
        for a, b in zip(mine.expert(li, e), ref._host[key]):
            np.testing.assert_array_equal(_bits(a), _bits(b))
            crc = zlib.crc32(_bits(a), crc)
        assert crc == mine.reader.record_crc(li, e), key


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("plan", list(PLANS))
@pytest.mark.parametrize("arch", ARCHS)
def test_tier_under_corruption_equals_the_reference(shards, arch, plan,
                                                    seed):
    mine, ref = _stores(shards[arch], plan, seed)
    L, E = mine.model.L, mine.model.E
    rng = np.random.default_rng(seed)
    pinned = []
    now = 0.0
    for step in range(300):
        op = int(rng.integers(8))
        key = (int(rng.integers(L)), int(rng.integers(E)))
        if op == 7:                    # the port alone: bytes, no decision
            mine.read_ahead([key, (key[0], (key[1] + 1) % E)])
            op = 0
        now += float(rng.choice([0.0, 0.5, 1.0]))
        outs = []
        for st in (mine, ref):
            if op == 0:
                outs.append(st.demand_host(key, now))
            elif op == 1:
                outs.append(st.request_host(key, now))
            elif op == 2:
                outs.append(st.advance(now))
            elif op == 3:
                outs.append(st.auto_prefetch(now, key[0]))
            elif op == 4:
                outs.append(st.scrub_tick(now))
            elif op == 5:
                st.note_predicted([key])
                outs.append(None)
            else:
                outs.append(None)
        if op == 6:                    # pin a resident key, or unpin one
            if pinned and (len(pinned) >= 4 or rng.random() < 0.5):
                k = pinned.pop(0)
                mine.unpin(k)
                ref.unpin(k)
            elif mine.host_resident(key):
                pinned.append(key)
                mine.pin(key)
                ref.pin(key)
        assert outs[0] == outs[1], (step, op, key, outs)
        assert mine.snapshot() == ref.snapshot(), (step, op, key)
        gm, gr = mine.guard, ref.guard
        assert (sorted(gm.quarantined), gm.healing, gm.n_episodes) == \
            (sorted(gr.quarantined), gr.healing, gr.n_episodes), step
        assert gm.n_episodes == gm.n_requarantined + len(gm.quarantined) \
            + len(gm.healing)
        _no_corrupt_resident(mine, ref)
    snap = mine.snapshot()
    assert snap["n_corrupt_detected"] > 0
    if plan == "corrupt_disk":
        assert snap["n_quarantined_experts"] > 0
    else:
        assert snap["n_scrubbed"] > 0 and snap["n_requarantined"] > 0
    for k in mine.guard.quarantined:
        assert not mine.host_resident(k)
    mine.close()


def slots_hold_their_records(eng):
    """Every occupied device slot's bytes, read back, have its shard
    record's CRC-32 (the device twin of the host check)."""
    for s, key in enumerate(eng.table.key_of_slot):
        if key is None:
            continue
        crc = 0
        for name in ("w_gate", "w_up", "w_down"):
            crc = zlib.crc32(_bits(eng.buffer[name][s].cpu()), crc)
        assert crc == eng.tiers.reader.record_crc(*key), (s, key)


@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("plan", list(PLANS))
@pytest.mark.parametrize("arch", ARCHS)
def test_served_under_corruption_emits_every_budget(smokes, shards, arch,
                                                    plan, path):
    cfg, params, _, _ = smokes[arch]
    sdir = shards[arch]
    store = TieredExpertStore(sdir, host_budget_bytes=_half(sdir),
                              verify=PLANS[plan])
    eng = SlotBufferEngine(cfg, _no_experts(params), Model(cfg),
                           n_slots_per_layer=3, max_seq=64, use_kernel=True,
                           use_superkernel=PATHS[path], store=store,
                           faults=getattr(FaultPlan, plan)(seed=0),
                           retry_backoff_s=0.0, device="cpu")
    rng = np.random.default_rng(7)
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, 12,
                                        dtype=np.int32),
                    max_new_tokens=5, request_id=i) for i in range(4)]
    rep = ServingEngine(eng, EngineServingConfig(
        max_batch=2, prefill_chunk=0, admission_cap=False)).serve(reqs)
    assert all(len(r.output) == r.max_new_tokens for r in reqs)
    assert rep.n_corrupt_detected > 0
    if plan == "corrupt_disk":
        assert rep.n_quarantined_experts > 0
    g = store.guard
    assert g.n_episodes == g.n_requarantined + len(g.quarantined) \
        + len(g.healing)
    slots_hold_their_records(eng)
    for k in g.quarantined:
        assert int(eng.table.slot_of[k]) < 0, f"quarantined {k} resident"
    store.close()


@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("plan", list(PLANS))
def test_served_under_corruption_equals_the_jax_engine(smokes, shards,
                                                       monkeypatch, plan,
                                                       path):
    arch = "olmoe-1b-7b"
    te, store, trep, je, jstore, jrep, _ = serve_against_jax(
        monkeypatch, smokes, shards[arch], arch, path, plan, PLANS[plan])
    gm, gr = store.guard, jstore.model.guard
    assert (sorted(gm.quarantined), gm.healing, gm.n_episodes) == \
        (sorted(gr.quarantined), gr.healing, gr.n_episodes)
    assert trep.n_corrupt_detected > 0
    if plan == "corrupt_disk":
        assert trep.n_quarantined_experts > 0
    slots_hold_their_records(te)
    store.close()
