"""The disk tier in the port against the reference (CPU).

- The shard format: shards exported by the reference read back bitwise
  through the port's reader and the reverse; both packages' exports of
  the same float32 / bf16 / f8 weights are byte-identical files with equal
  manifests (CRCs included).
- The reference's `ShardError` and `HostTierModel` cases
  (`tests/test_expert_tiers.py`) on the port's copies.
- `HostTierModel` call for call against the reference's over seeded random
  sequences of every call the engine makes, with and without a fault
  plan's disk scope and with integrity checks drawn from the plan:
  equal return values, snapshots, LRU order and pins after every call.
- The port's `SlotBufferEngine` on a `TieredExpertStore` at half the
  expert bytes gives bitwise the pre-staged engine's greedy tokens and
  logits, with host evictions, on olmoe and DeepSeek smoke and on both
  decode paths (the reference's engine test, mirrored), also from params
  that carry no experts.
- Served through `ServingEngine` against the JAX engine with its own
  `TieredExpertStore` over the same shards (the JAX superkernel runs its
  Pallas kernels in interpret mode), teacher-forced on the JAX server's
  tokens (`test_torch_faults.TeacherForced`: bf16 logits of two
  frameworks may part at a near-tie, 5e-2): every `SlotPathStats` counter
  (host hits, misses and disk stall included), the tier's snapshot and the
  `ServingReport`'s tier keys equal, on olmoe smoke with no plan and under
  `disk_flaky(0)`; single-stream, call by call, on olmoe and DeepSeek.
"""
import json
import os
import shutil
import zlib

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as jax_smoke
from repro.core import expert_tiers as ref_tiers
from repro.core import faults as jax_faults
from repro.core import step_size as ref_step
from repro.core.expert_buffer import HostExpertStore as RefHostStore
from repro.runtime.engine import Engine as JaxEngine
from repro.runtime.engine import SlotBufferEngine as JaxSlotBufferEngine
from repro.runtime.engine import build_host_store
from repro.runtime.request import Request as JaxRequest
from repro.runtime.serving import EngineServingConfig as JaxServingConfig
from repro.runtime.serving import ServingEngine as JaxServingEngine
from repro_torch.bridge import params_from_reference
from repro_torch.configs import get_smoke_config
from repro_torch.core import step_size
from repro_torch.core.expert_tiers import (SHARD_MANIFEST, ExpertShardReader,
                                          HostTierModel, ShardError,
                                          TieredExpertStore, crc32_combine,
                                          export_expert_shards)
from repro_torch.core.faults import FaultInjector, FaultPlan, StepWatchdog
from repro_torch.models.transformer import Model
from repro_torch.runtime.engine import SlotBufferEngine
from repro_torch.runtime.request import Request
from repro_torch.runtime.serving import EngineServingConfig, ServingEngine
from test_torch_faults import TeacherForced, _never_trips

DTYPES = {"f32": np.float32, "bf16": ml_dtypes.bfloat16,
          "f8": ml_dtypes.float8_e4m3fn}
PATHS = {"unfused": False, "superkernel": True}
ARCHS = ("olmoe-1b-7b", "deepseek-v2-lite")
COUNTERS = ("swap_calls", "swap_experts", "prefetched", "prefetch_hits",
            "late_hits", "demand_misses", "host_syncs", "steps",
            "spec_layers", "replays", "link_failures", "retries",
            "degraded_steps", "host_hits", "host_misses", "disk_stall_s")
TIER_KEYS = ("n_host_hits", "n_host_misses", "disk_stall_s",
             "n_corrupt_detected", "n_requarantined", "n_scrubbed",
             "n_quarantined_experts")


def _bits(a):
    """Raw-storage view, so bf16 / f8 compare bitwise (numpy or torch)."""
    raw = {1: np.uint8, 2: np.uint16, 4: np.uint32}
    if isinstance(a, torch.Tensor):
        ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32}
        size = a.element_size()
        return a.contiguous().view(ints[size]).numpy().view(raw[size])
    a = np.asarray(a)
    return a.view(raw[a.itemsize])


def _to_torch(a):
    a = np.ascontiguousarray(a)
    if str(a.dtype) == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    if str(a.dtype) == "float8_e4m3fn":
        return torch.from_numpy(a.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    return torch.from_numpy(a.copy())


def _weights(rng, dtype, layers=2, experts=4, d=6, f=10):
    """{layer: (w_gate, w_up, w_down)} numpy stacks of `dtype`."""
    out = {}
    for li in range(layers):
        shapes = ((experts, d, f), (experts, d, f), (experts, f, d))
        out[li] = tuple(rng.standard_normal(s).astype(np.float32)
                        .astype(dtype) for s in shapes)
    return out


def _ref_store(layers):
    st = RefHostStore()
    for li, ws in layers.items():
        st.add_layer(li, *ws)
    return st


def _port_layers(layers):
    return {li: tuple(_to_torch(w) for w in ws) for li, ws in layers.items()}


def _port_store_dir(tmp_path, rng, layers=2, experts=4, dtype=np.float32):
    w = _weights(rng, dtype, layers=layers, experts=experts)
    return export_expert_shards(_port_layers(w), str(tmp_path / "sh")), w


# --------------------------------------------------------------------------
# shard format against the reference
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", list(DTYPES))
def test_both_exports_are_byte_identical(tmp_path, dtype):
    w = _weights(np.random.default_rng(0), DTYPES[dtype])
    a = ref_tiers.export_expert_shards(_ref_store(w), str(tmp_path / "ref"))
    b = export_expert_shards(_port_layers(w), str(tmp_path / "port"))
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    for name in os.listdir(a):
        with open(os.path.join(a, name), "rb") as fa, \
                open(os.path.join(b, name), "rb") as fb:
            assert fa.read() == fb.read(), name
    ma = json.load(open(os.path.join(a, SHARD_MANIFEST)))
    assert ma == json.load(open(os.path.join(b, SHARD_MANIFEST)))
    assert {t["dtype"] for rec in ma["layers"] for t in rec["tensors"]} \
        == {str(np.dtype(DTYPES[dtype]))}


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_reference_shards_read_bitwise_through_the_port(tmp_path, dtype):
    w = _weights(np.random.default_rng(1), DTYPES[dtype])
    sdir = ref_tiers.export_expert_shards(_ref_store(w),
                                          str(tmp_path / "sh"))
    rd = ExpertShardReader(sdir)
    assert rd.layers() == [0, 1] and rd.has_checksums()
    for li in range(2):
        whole = rd.read_layer(li)
        for e in range(4):
            got = rd.read_expert(li, e)
            for t in range(3):
                np.testing.assert_array_equal(_bits(got[t]),
                                              _bits(w[li][t][e]))
                np.testing.assert_array_equal(_bits(whole[t][e]),
                                              _bits(w[li][t][e]))
            buf = np.empty(rd.record_nbytes(li), np.uint8)
            rd.read_into(li, e, buf)
            assert zlib.crc32(buf) == rd.record_crc(li, e)
            np.testing.assert_array_equal(buf, rd.read_record_bytes(li, e))
    rd.close()


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_port_shards_read_bitwise_through_the_reference(tmp_path, dtype):
    w = _weights(np.random.default_rng(2), DTYPES[dtype])
    sdir = export_expert_shards(_port_layers(w), str(tmp_path / "sh"))
    rd = ref_tiers.ExpertShardReader(sdir)
    for li in range(2):
        for e in range(4):
            got = rd.read_expert(li, e)
            for t in range(3):
                assert got[t].dtype == w[li][t].dtype
                np.testing.assert_array_equal(_bits(got[t]),
                                              _bits(w[li][t][e]))


def test_crc32_combine_equals_one_pass():
    rng = np.random.default_rng(3)
    data = rng.integers(0, 256, 100_003, dtype=np.uint8)
    for cut in (0, 1, 4096, 50_000, 100_003):
        a, b = data[:cut], data[cut:]
        assert crc32_combine(zlib.crc32(a), zlib.crc32(b), b.size) \
            == zlib.crc32(data)


def test_chunked_reads_checksum_records_larger_than_a_chunk(tmp_path,
                                                            monkeypatch):
    """A record spans several I/O chunks: the pool's bytes and the CRC
    taken chunk by chunk equal the shard's."""
    from repro_torch.core import expert_tiers
    monkeypatch.setattr(expert_tiers, "READ_CHUNK", 100)
    sdir, w = _port_store_dir(tmp_path, np.random.default_rng(4))
    st = TieredExpertStore(sdir, verify="promote")
    for e in range(4):
        assert st.demand_host((1, e), 0.0) is not None
    assert st.guard.n_corrupt_detected == 0
    for e in range(4):
        for t, got in enumerate(st.expert(1, e)):
            np.testing.assert_array_equal(_bits(got), _bits(w[1][t][e]))
    assert st.io_stats()["bytes_read"] == 4 * st.expert_nbytes
    st.close()


# --------------------------------------------------------------------------
# the reference's reader and store cases on the port
# --------------------------------------------------------------------------

def test_shard_noncontiguous_subset_and_cross_layer_gather(tmp_path):
    sdir, w = _port_store_dir(tmp_path, np.random.default_rng(1), layers=3,
                              experts=8)
    tiered = TieredExpertStore(sdir)
    subset = [6, 1, 3]
    for key in [(1, e) for e in subset]:
        assert tiered.demand_host(key, 0.0) is not None
    for t, g in enumerate(tiered.gather(1, subset)):
        np.testing.assert_array_equal(g.numpy(), w[1][t][subset])
    keys = [(0, 5), (2, 0), (1, 6), (0, 2), (2, 7)]
    for key in keys:
        assert tiered.demand_host(key, 0.0) is not None
    for t, g in enumerate(tiered.gather_many(keys)):
        np.testing.assert_array_equal(
            g.numpy(), np.stack([w[li][t][e] for li, e in keys]))
    tiered.close()


def test_gather_before_residency_is_a_scheduling_bug(tmp_path):
    sdir, _ = _port_store_dir(tmp_path, np.random.default_rng(2))
    tiered = TieredExpertStore(sdir)
    with pytest.raises(RuntimeError, match="not staged"):
        tiered.gather(0, [0])
    with pytest.raises(RuntimeError, match="not staged"):
        tiered.expert(0, 0)


@pytest.mark.parametrize("fault", ["truncated", "bad_nbytes", "missing",
                                   "not_json"])
def test_truncated_and_corrupt_shards_raise_shard_error(tmp_path, fault):
    sdir, _ = _port_store_dir(tmp_path, np.random.default_rng(3))
    t = str(tmp_path / fault)
    shutil.copytree(sdir, t)
    man_path = os.path.join(t, SHARD_MANIFEST)
    match = None
    if fault == "truncated":
        binf = os.path.join(t, "layer_00000.bin")
        with open(binf, "r+b") as f:
            f.truncate(os.path.getsize(binf) - 8)
        match = "truncated"
    elif fault == "bad_nbytes":
        man = json.load(open(man_path))
        man["layers"][0]["tensors"][0]["nbytes"] += 4
        json.dump(man, open(man_path, "w"))
    elif fault == "missing":
        os.remove(os.path.join(t, "layer_00001.bin"))
        match = "missing"
    else:
        with open(man_path, "w") as f:
            f.write("{not json")
    with pytest.raises(ShardError, match=match):
        ExpertShardReader(t)


def test_truncation_after_open_fails_at_materialization(tmp_path):
    sdir, _ = _port_store_dir(tmp_path, np.random.default_rng(4))
    rd = ExpertShardReader(sdir)
    binf = os.path.join(sdir, "layer_00001.bin")
    rec = rd.record_nbytes(1)
    with open(binf, "r+b") as f:
        f.truncate(2 * rec + rec // 2)
    with pytest.raises(ShardError, match="truncated"):
        rd.read_expert(1, 2)
    rd.read_expert(1, 0)
    with pytest.raises(ShardError, match="truncated"):
        rd.read_expert(1, 3)
    # the pool's positional reads see the same truncation
    buf = np.empty(rec, np.uint8)
    rd.read_into(1, 1, buf)
    with pytest.raises(ShardError, match="truncated"):
        rd.read_into(1, 2, buf)
    with pytest.raises(ShardError, match="truncated"):
        rd.read_layer(1)
    rd.close()


def test_a_failed_background_read_raises(tmp_path):
    """A real I/O fault is never swallowed: a promotion whose read hits a
    truncated file raises where its bytes are used."""
    sdir, _ = _port_store_dir(tmp_path, np.random.default_rng(5))
    st = TieredExpertStore(sdir)
    with open(os.path.join(sdir, "layer_00000.bin"), "r+b") as f:
        f.truncate(int(st.expert_nbytes))
    assert st.demand_host((0, 3), 0.0) is not None
    with pytest.raises(ShardError, match="truncated"):
        st.expert(0, 3)


def test_manifest_checksums_stamped_and_optional(tmp_path):
    sdir, _ = _port_store_dir(tmp_path, np.random.default_rng(5))
    rd = ExpertShardReader(sdir)
    assert rd.has_checksums()
    for li in rd.layers():
        for e in range(rd.num_experts(li)):
            assert zlib.crc32(rd.read_record_bytes(li, e)) \
                == rd.record_crc(li, e)
    man_path = os.path.join(sdir, SHARD_MANIFEST)
    man = json.load(open(man_path))
    for rec in man["layers"]:
        del rec["crc32"]
    json.dump(man, open(man_path, "w"))
    rd2 = ExpertShardReader(sdir)
    assert not rd2.has_checksums()
    assert rd2.record_crc(0, 0) is None
    assert TieredExpertStore(sdir, verify="promote").verify == "off"


def _tier(budget_experts, **kw):
    kw.setdefault("disk_bandwidth", 1e12)  # effectively instant promotions
    return HostTierModel(num_layers=2, num_experts=8, expert_nbytes=1000.0,
                         host_budget_bytes=budget_experts * 1000.0, **kw)


def test_budget_lru_eviction_order():
    m = _tier(2)
    for e in range(3):
        assert m.demand((0, e), float(e)) is not None
    assert not m.host_resident((0, 0))
    assert m.host_resident((0, 1)) and m.host_resident((0, 2))
    assert m.evictions == 1 and m.host_bytes == 2000.0
    assert m.demand((0, 1), 3.0) == (0.0, True)
    assert m.demand((0, 3), 4.0) is not None
    assert not m.host_resident((0, 2)) and m.host_resident((0, 1))


def test_pinned_expert_survives_eviction_churn():
    m = _tier(2)
    assert m.demand((0, 0), 0.0) is not None
    m.pin((0, 0))
    for e in range(1, 6):
        assert m.demand((0, e), float(e)) is not None
        assert m.host_resident((0, 0)), f"pinned entry evicted at e={e}"
    m.unpin((0, 0))
    assert m.demand((0, 6), 9.0) is not None
    assert not m.host_resident((0, 0))


def test_demand_overflows_budget_when_all_residents_pinned():
    m = _tier(1)
    assert m.demand((0, 0), 0.0) is not None
    m.pin((0, 0))
    assert m.demand((0, 1), 1.0) is not None
    assert m.host_resident((0, 0)) and m.host_resident((0, 1))
    assert m.host_bytes == 2000.0


def test_disk_prefetch_converts_misses_to_hits():
    m = _tier(8, disk_bandwidth=1e6, prefetch=True)
    m.note_layer_demand(2)
    for e in range(4):
        m.note_predicted([(0, e)])
        m.request((0, e), 0.0)
    m.advance(10.0)
    for e in range(4):
        stall, hit = m.demand((0, e), 10.0)
        assert hit and stall == 0.0
    assert m.host_hits == 4 and m.host_misses == 0


def test_pool_capacity_covers_pins_and_an_overflow(tmp_path, monkeypatch):
    """The pool holds max(budget, pins + 1) + 1 records (with no read-ahead
    spares) and never grows: with every resident pinned a demand lands
    past the budget, the next evicts it; pinning past the stated pins uses
    the staging spare, then a demand raises instead of growing the pool."""
    from repro_torch.core import expert_tiers
    monkeypatch.setattr(expert_tiers, "READ_AHEAD", 0)
    sdir, _ = _port_store_dir(tmp_path, np.random.default_rng(6),
                              experts=8)
    nbytes = TieredExpertStore(sdir).expert_nbytes
    st = TieredExpertStore(sdir, host_budget_bytes=2 * nbytes)
    st.attach(n_pins=3)
    assert st.budget_records == 2 and st.capacity == 5
    for e in range(3):
        assert st.demand_host((0, e), float(e)) is not None
        st.pin((0, e))
    assert st.demand_host((0, 3), 3.0) is not None   # over the budget
    assert st.demand_host((0, 4), 4.0) is not None   # evicts (0, 3)
    assert len(st._host) == 4 and not st.host_resident((0, 3))
    assert len(st._records) == 5
    st.pin((0, 4))                                   # a fourth pin
    assert st.demand_host((0, 5), 5.0) is not None
    st.pin((0, 5))
    with pytest.raises(RuntimeError, match="pool exhausted"):
        st.demand_host((0, 6), 6.0)
    assert len(st._records) == 5


@pytest.mark.parametrize("verify", ["off", "promote"])
def test_read_ahead_moves_bytes_not_decisions(tmp_path, verify):
    """Records read ahead of a demand batch land as its promotions (read
    once), leftovers are released at the next batch, and the tier's
    decisions are those of a store that never read ahead."""
    from repro_torch.core.expert_tiers import READ_AHEAD
    sdir, w = _port_store_dir(tmp_path, np.random.default_rng(7),
                              experts=8)
    budget = 3 * TieredExpertStore(sdir).expert_nbytes
    a = TieredExpertStore(sdir, host_budget_bytes=budget, verify=verify)
    b = TieredExpertStore(sdir, host_budget_bytes=budget, verify=verify)
    assert a.capacity == 3 + 1 + READ_AHEAD     # no pins: budget + staged
    for t, batch in enumerate([[0, 1, 2], [2, 5, 6, 7], [1, 3]]):
        keys = [(1, e) for e in batch]
        a.read_ahead(keys + [(0, 4)])        # (0, 4) is never demanded
        for key in keys:
            assert a.demand_host(key, float(t)) == b.demand_host(key,
                                                                 float(t))
            for i, got in enumerate(a.expert(*key)):
                np.testing.assert_array_equal(got.numpy(), w[1][i][key[1]])
        assert a.snapshot() == b.snapshot()
    assert set(a._ahead) == {(0, 4)}
    a.read_ahead([])
    assert not a._ahead and len(a._free) == a.capacity - len(a._host)
    a.close()
    b.close()
    # each promotion read once; (0, 4) at most once a batch (a dropped read
    # may be cancelled before it starts)
    n = b.snapshot()["promotions"]
    assert b.io_stats()["bytes_read"] == n * b.expert_nbytes
    extra = (a.io_stats()["bytes_read"] - n * a.expert_nbytes) \
        / a.expert_nbytes
    assert extra in (0, 1, 2, 3), extra


# --------------------------------------------------------------------------
# HostTierModel call for call against the reference
# --------------------------------------------------------------------------

def _model_pair(plan, seed):
    kw = dict(num_layers=3, num_experts=8, expert_nbytes=1000.0,
              host_budget_bytes=7000.0, disk_bandwidth=2500.0,
              disk_horizon_max=6)
    mine = HostTierModel(controller=step_size.StepSizeController(), **kw)
    ref = ref_tiers.HostTierModel(controller=ref_step.StepSizeController(),
                                  **kw)
    if plan is None:
        return mine, ref
    make = {"disk_flaky": "disk_flaky", "corrupt": "corrupt_flaky"}[plan]
    for m, mod in ((mine, None), (ref, jax_faults)):
        plan_cls = FaultPlan if mod is None else mod.FaultPlan
        inj_cls = FaultInjector if mod is None else mod.FaultInjector
        inj = inj_cls(getattr(plan_cls, make)(seed=seed))
        m.set_faults(inj, retry_max=2)
        if plan == "corrupt":
            dv = inj.disk_view()
            m.configure_integrity(
                "scrub", scrub_budget=2, refetch_max=2,
                verify_fn=lambda key, dv=dv: not (
                    dv.disk_record_corrupt(key) or dv.promotion_corrupt(key)),
                scrub_fn=lambda key, dv=dv: not dv.host_copy_corrupt(key))
    return mine, ref


def _state(m):
    return (m.snapshot(), list(m._resident), dict(m._pins),
            sorted(m.pf.issued), m.popularity.tolist(),
            sorted(m.guard.quarantined), dict(m.guard.healing))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("plan", [None, "disk_flaky", "corrupt"])
def test_host_tier_model_call_for_call(plan, seed):
    mine, ref = _model_pair(plan, seed)
    rng = np.random.default_rng(seed)
    ops = ("demand", "request", "advance", "auto_prefetch", "pin", "unpin",
           "note_access", "note_predicted", "note_layer_demand", "scrub",
           "stall")
    now = 0.0
    for step in range(400):
        op = ops[rng.integers(len(ops))]
        key = (int(rng.integers(3)), int(rng.integers(8)))
        n = int(rng.integers(1, 6))
        now += float(rng.choice([0.0, 0.1, 0.5, 1.0]))
        outs = []
        for m in (mine, ref):
            out = None
            if op == "demand":
                out = m.demand(key, now)
            elif op == "request":
                out = m.request(key, now)
            elif op == "advance":
                out = m.advance(now)
            elif op == "auto_prefetch":
                out = m.auto_prefetch(now, key[0])
            elif op == "pin":
                if m.host_resident(key):
                    m.pin(key)
            elif op == "unpin":
                m.unpin(key)
            elif op == "note_access":
                m.note_access(key)
            elif op == "note_predicted":
                m.note_predicted([key, (key[0], (key[1] + 1) % 8)])
            elif op == "note_layer_demand":
                m.note_layer_demand(n)
            elif op == "scrub":
                out = m.scrub_tick(now)
            else:
                m.controller.record_stall()
            outs.append(out)
        assert outs[0] == outs[1], (step, op, key, outs)
        assert _state(mine) == _state(ref), (step, op, key)
    snap = mine.snapshot()
    assert snap["promotions"] > 0 and snap["evictions"] > 0
    if plan == "corrupt":
        g = mine.guard
        assert g.n_episodes == g.n_requarantined + len(g.quarantined) \
            + len(g.healing)


# --------------------------------------------------------------------------
# the engine through the tier
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def smokes():
    """arch -> (port config, port params, JAX config, JAX engine)."""
    out = {}
    for arch in ARCHS:
        jcfg = jax_smoke(arch)
        eng = JaxEngine(jcfg, max_seq=64)
        out[arch] = (get_smoke_config(arch), params_from_reference(
            jax.tree.map(np.asarray, eng.params)), jcfg, eng)
    return out


@pytest.fixture(scope="module")
def shards(smokes, tmp_path_factory):
    """arch -> the reference's shard directory of its smoke experts."""
    root = tmp_path_factory.mktemp("shards")
    return {arch: ref_tiers.export_expert_shards(
        build_host_store(jeng.model, jeng.params), str(root / arch))
        for arch, (_, _, _, jeng) in smokes.items()}


def _half(sdir):
    return 0.5 * TieredExpertStore(sdir).total_expert_bytes


def _no_experts(params):
    out = dict(params)
    out["layers"] = [
        dict(lp, moe={k: v for k, v in lp["moe"].items()
                      if k not in ("w_gate", "w_up", "w_down")})
        if "moe" in lp else lp for lp in params["layers"]]
    return out


def _greedy_rows(sb, prompt, n_steps):
    lg, st = sb.prefill(prompt)
    rows = [lg]
    for _ in range(n_steps):
        lg, st = sb.decode_step(lg.argmax(-1), st)
        rows.append(lg)
    return rows


@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_bit_exact_through_tier_at_half_budget(smokes, shards, arch,
                                                      path):
    cfg, params, _, _ = smokes[arch]
    kw = dict(n_slots_per_layer=2, step_size=1, max_seq=48, use_kernel=True,
              use_superkernel=PATHS[path], device="cpu")
    prompt = np.random.default_rng(11).integers(0, cfg.vocab_size, (1, 8))
    staged = SlotBufferEngine(cfg, params, Model(cfg), **kw)
    want = _greedy_rows(staged, prompt, 6)
    store = TieredExpertStore(shards[arch],
                              host_budget_bytes=_half(shards[arch]))
    sb = SlotBufferEngine(cfg, _no_experts(params), Model(cfg), store=store,
                          **kw)
    got = _greedy_rows(sb, prompt, 6)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert store.snapshot()["evictions"] > 0, "no host-tier churn"
    assert sb.stats.host_hits + sb.stats.host_misses > 0
    # the oracle reads the shards, not the tier: the pre-staged oracle's
    assert torch.equal(sb.reference_prefill(prompt)[0],
                       staged.reference_prefill(prompt)[0])
    store.close()


def test_engine_without_a_store_is_unchanged(smokes):
    cfg, params, _, _ = smokes["olmoe-1b-7b"]
    sb = SlotBufferEngine(cfg, params, Model(cfg), n_slots_per_layer=2,
                          device="cpu")
    assert sb.tiers is None
    assert sb.integrity_counters() == dict(
        n_corrupt_detected=0, n_requarantined=0, n_scrubbed=0,
        n_quarantined_experts=0)


def _jax_tiered(jcfg, jeng, sdir, plan, verify, nt, kw):
    """The JAX engine on its own `TieredExpertStore` over `sdir`."""
    store = ref_tiers.TieredExpertStore(sdir, host_budget_bytes=_half(sdir),
                                        verify=verify)
    fk = {} if plan is None else dict(
        faults=getattr(jax_faults.FaultPlan, plan)(seed=0),
        watchdog=jax_faults.StepWatchdog(**nt["watchdog_kw"]))
    return store, JaxSlotBufferEngine(jcfg, jeng.params, jeng.model,
                                      store=store, **fk, **kw)


def serve_against_jax(monkeypatch, smokes, sdir, arch, path, plan=None,
                      verify="off"):
    """Serve four requests on the port's tiered engine and the JAX one over
    the same shards (teacher-forced on the JAX server's tokens); returns
    (port engine, port store, port report, JAX engine, JAX store, JAX
    report, port requests)."""
    cfg, params, jcfg, jeng = smokes[arch]
    nt = _never_trips()
    kw = dict(n_slots_per_layer=3, max_seq=64, use_kernel=True,
              use_superkernel=PATHS[path], retry_backoff_s=0.0)
    scfg = dict(max_batch=2, prefill_chunk=0, admission_cap=False,
                **(nt["serving_kw"] if plan else {}))
    jstore, je = _jax_tiered(jcfg, jeng, sdir, plan, verify, nt, kw)
    store = TieredExpertStore(sdir, host_budget_bytes=_half(sdir),
                              verify=verify)
    fk = {} if plan is None else dict(
        faults=getattr(FaultPlan, plan)(seed=0),
        watchdog=StepWatchdog(**nt["watchdog_kw"]))
    te = SlotBufferEngine(cfg, _no_experts(params), Model(cfg), store=store,
                          device="cpu", **fk, **kw)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, int(n), dtype=np.int32)
               for n in rng.integers(8, 17, 4)]
    budgets = [6, 3, 6, 4]
    treqs = [Request(prompt=p, max_new_tokens=n, request_id=i)
             for i, (p, n) in enumerate(zip(prompts, budgets))]
    jreqs = [JaxRequest(prompt=p, max_new_tokens=n, request_id=i)
             for i, (p, n) in enumerate(zip(prompts, budgets))]
    jrep = JaxServingEngine(je, JaxServingConfig(**scfg)).serve(jreqs)
    tsrv = ServingEngine(te, EngineServingConfig(**scfg))
    forced = TeacherForced(monkeypatch, tsrv,
                           {r.request_id: list(r.output) for r in jreqs})
    trep = tsrv.serve(treqs)
    assert [r.output for r in treqs] == [r.output for r in jreqs]
    assert [len(r.output) for r in treqs] == budgets
    assert len(forced.ties) <= 2, forced.ties
    a, w = te.stats.snapshot(), je.stats.snapshot()
    assert {k: a[k] for k in COUNTERS} == {k: w[k] for k in COUNTERS}, \
        {k: (a[k], w[k]) for k in COUNTERS if a[k] != w[k]}
    assert store.snapshot() == jstore.snapshot()
    assert {k: getattr(trep, k) for k in TIER_KEYS} == \
        {k: getattr(jrep, k) for k in TIER_KEYS}
    return te, store, trep, je, jstore, jrep, treqs


@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("plan", [None, "disk_flaky"])
def test_served_through_tier_equals_the_jax_engine(smokes, shards,
                                                   monkeypatch, plan, path):
    """olmoe smoke, with no plan and with `disk_flaky(seed=0)` (the engine
    hands the tier the plan's disk scope). DeepSeek's served population
    parts from the JAX engine's at a bf16 router near-tie even without the
    tier (request 0's first decode step: the pre-staged engines' prefetch
    hits differ too), so DeepSeek is held single-stream below."""
    arch = "olmoe-1b-7b"
    te, store, trep, *_ = serve_against_jax(monkeypatch, smokes,
                                            shards[arch], arch, path, plan)
    assert trep.n_host_misses > 0 and store.snapshot()["evictions"] > 0
    if plan:
        assert store.snapshot()["n_disk_failures"] > 0
    store.close()


@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("arch", ARCHS)
def test_single_stream_tier_decisions_equal_the_jax_engine(smokes, shards,
                                                           arch, path):
    """One prompt prefilled and decoded single-stream, teacher-forced on
    the JAX engine's tokens: after every call the engine counters and the
    tier's snapshot equal the JAX engine's."""
    cfg, params, jcfg, jeng = smokes[arch]
    kw = dict(n_slots_per_layer=3, max_seq=64, use_kernel=True,
              use_superkernel=PATHS[path])
    sdir = shards[arch]
    jstore, je = _jax_tiered(jcfg, jeng, sdir, None, "off", None, kw)
    store = TieredExpertStore(sdir, host_budget_bytes=_half(sdir))
    te = SlotBufferEngine(cfg, _no_experts(params), Model(cfg), store=store,
                          device="cpu", **kw)
    prompt = np.random.default_rng(5).integers(0, cfg.vocab_size, (1, 12),
                                               dtype=np.int32)
    lj, sj = je.prefill(jax.numpy.asarray(prompt))
    lt, st = te.prefill(prompt)
    keys = [k for k in COUNTERS if k != "steps"]
    for step in range(7):
        a, w = te.stats.snapshot(), je.stats.snapshot()
        assert {k: a[k] for k in keys} == {k: w[k] for k in keys}, step
        assert store.snapshot() == jstore.snapshot(), step
        tok = int(np.asarray(lj, np.float32).argmax())
        row = lt[0].float()
        assert float(row.max() - row[tok]) <= 5e-2, step
        lj, sj = je.decode_step(jax.numpy.asarray([tok], jax.numpy.int32),
                                sj)
        lt, st = te.decode_step(torch.tensor([tok]), st)
    assert store.snapshot()["evictions"] > 0
    store.close()
