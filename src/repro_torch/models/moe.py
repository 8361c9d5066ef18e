"""Mixture-of-Experts layer: router, dispatch/combine, slot-buffer path.

- `moe_reference` dense all-experts oracle (smoke sizes only)
- `moe_grouped`   capacity-buffer grouped MoE over resident weights (the
                  reference's `moe_grouped`); on a mesh, expert-parallel
                  (`_moe_shard_map`): experts over ``model``, groups over
                  the batch axes
- `moe_slotbuf`   ExpertFlow runtime path: expert weights are read from a
                  bounded slot buffer through an expert -> slot table
- `moe_slotbuf_fused` the decode superkernel's MoE entry: routing, top-k,
                  slot lookup and expert FFN in one kernel call

Shared experts (DeepSeek style), where the params have them, are one dense
SwiGLU over every token, added after the routed experts on every path; they
stay resident and never go through the slot buffer.

Everything here is deterministic on the card: top-k breaks ties towards the
lowest expert id through a stable sort, and the combine sums each token's k
contributions in one fixed order instead of scatter-adding them.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.distributed import sharding as shd
from repro_torch.kernels.decode_superkernel import fused_moe_entry
from repro_torch.kernels.slot_gather import slot_ffn
from repro_torch.models.layers import swiglu, trunc_normal


class RouterOutput(NamedTuple):
    expert_ids: torch.Tensor   # (T, k) int64
    gates: torch.Tensor        # (T, k) float32, normalized if requested
    logits: torch.Tensor       # (T, E) float32
    probs: torch.Tensor        # (T, E) float32 softmax


def init_moe_params(d_model: int, moe, dtype=torch.bfloat16, **kw):
    E, f = moe.num_experts, moe.d_expert
    p = {
        "router": trunc_normal((d_model, E), d_model ** -0.5, torch.float32,
                               **kw),
        "w_gate": trunc_normal((E, d_model, f), d_model ** -0.5, dtype, **kw),
        "w_up": trunc_normal((E, d_model, f), d_model ** -0.5, dtype, **kw),
        "w_down": trunc_normal((E, f, d_model), f ** -0.5, dtype, **kw),
    }
    if moe.num_shared_experts:
        fs = (moe.d_shared or moe.d_expert) * moe.num_shared_experts
        p["shared"] = {
            "w_gate": trunc_normal((d_model, fs), d_model ** -0.5, dtype,
                                   **kw),
            "w_up": trunc_normal((d_model, fs), d_model ** -0.5, dtype, **kw),
            "w_down": trunc_normal((fs, d_model), fs ** -0.5, dtype, **kw),
        }
    return p


def _add_shared(params, x: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """out + the shared experts' SwiGLU of x, where the layer has them."""
    if "shared" not in params:
        return out
    s = params["shared"]
    return out + swiglu(x, s["w_gate"], s["w_up"], s["w_down"])


def top_k_first_max(vals: torch.Tensor, k: int):
    """Top-k along the last axis with ties going to the lowest index (the
    order `lax.top_k` and the kernels' first-max rule give; `torch.topk`
    promises no order among ties)."""
    s, i = torch.sort(vals, dim=-1, descending=True, stable=True)
    return s[..., :k], i[..., :k]


def route(router_w: torch.Tensor, x: torch.Tensor, top_k: int,
          norm_topk: bool = True,
          logit_bias: Optional[torch.Tensor] = None) -> RouterOutput:
    """Top-k softmax routing in fp32. x: (T, d) -> assignments over E
    experts.

    `logit_bias` ((E,) or (T, E), fp32, additive) is §3.4 cache-aware
    routing: the engine passes 0 for resident experts and -strength for the
    others (`core.cache_aware.residency_logit_bias`), so a non-resident
    expert loses its top-k place only to a resident one within `strength`
    logits. The returned logits and probs are the biased ones. None computes
    exactly what the unbiased router computes."""
    logits = x.float() @ router_w.float()
    if logit_bias is not None:
        logits = logits + logit_bias.float()
    probs = torch.softmax(logits, dim=-1)
    gates, expert_ids = top_k_first_max(probs, top_k)
    if norm_topk:
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return RouterOutput(expert_ids, gates, logits, probs)


def load_balancing_loss(probs: torch.Tensor, expert_ids: torch.Tensor,
                        num_experts: int) -> torch.Tensor:
    """Switch-style auxiliary loss: E * sum_e (share of assignments to e) *
    (mean router probability of e). probs: (T, E); expert_ids: (T, k)."""
    counts = torch.bincount(expert_ids.reshape(-1).long(),
                            minlength=num_experts).float()
    frac_tokens = counts / torch.clamp(counts.sum(), min=1.0)
    frac_probs = probs.float().mean(dim=0)
    return num_experts * torch.sum(frac_tokens * frac_probs)


def moe_reference(params, x: torch.Tensor, moe):
    """Computes ALL experts for ALL tokens then combines. O(T*E*f)."""
    T, d = x.shape
    r = route(params["router"], x, moe.top_k, moe.router_norm_topk)
    g = torch.einsum("td,edf->tef", x, params["w_gate"])
    u = torch.einsum("td,edf->tef", x, params["w_up"])
    h = F.silu(g) * u
    y_all = torch.einsum("tef,efd->ted", h, params["w_down"])   # (T, E, d)
    # top-k ids are distinct per token, so no two gates share an entry
    comb = torch.zeros((T, moe.num_experts), dtype=torch.float32,
                       device=x.device).scatter_(1, r.expert_ids, r.gates)
    out = torch.einsum("te,ted->td", comb.to(x.dtype), y_all)
    return _add_shared(params, x, out), r


def compute_dispatch(expert_ids: torch.Tensor, num_experts: int,
                     capacity: int):
    """Static-shape dispatch plan from (T, k) assignments.

    Returns (sorted_token, sorted_expert, position_in_expert, keep_mask,
    order) — all (T*k,). Assignments beyond `capacity` per expert drop.
    """
    return _dispatch_plan(expert_ids, num_experts, capacity)[:5]


def _dispatch_plan(expert_ids: torch.Tensor, num_experts: int,
                   capacity: int):
    """`compute_dispatch` plus its (num_experts,) bincount of assignments
    per expert (before the capacity cut)."""
    T, k = expert_ids.shape
    flat_e = expert_ids.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    sorted_tok = order // k
    # a fixed-length bincount (bincount's length follows the data)
    counts = torch.zeros(num_experts, dtype=sorted_e.dtype,
                         device=sorted_e.device).scatter_add_(
        0, sorted_e, torch.ones_like(sorted_e))
    starts = torch.cumsum(counts, 0) - counts              # exclusive cumsum
    pos = torch.arange(T * k, device=expert_ids.device) - starts[sorted_e]
    keep = pos < capacity
    return sorted_tok, sorted_e, pos, keep, order, counts


def _dispatch_gather(x: torch.Tensor, group_ids: torch.Tensor, n_groups: int,
                     capacity: int):
    """Inverse-permutation gather dispatch.

    Scatters only the small int slot -> token map and builds the
    (n_groups, capacity, d) buffer with one gather. group_ids may equal
    n_groups (the sentinel group): those assignments, like over-capacity
    ones, write to an extra sentinel row that is sliced off.

    Returns (buf, tok, gid, keep, order, flat_slot, counts) where flat_slot
    indexes rows of buf.reshape(n_groups*capacity, d), valid only where
    `keep & (gid < n_groups)`, and counts (n_groups,) are the assignments
    per group before the capacity cut (group g's rows of buf that hold
    tokens are its first min(counts[g], capacity)).
    """
    T, d = x.shape
    tok, gid, pos, keep, order, counts = _dispatch_plan(
        group_ids, n_groups + 1, capacity)
    pos_c = torch.where(keep, pos, torch.full_like(pos, capacity - 1))
    flat_slot = gid * capacity + pos_c                       # (T*k,)
    rows = n_groups * capacity
    slot_tok = torch.full((rows + 1,), T, dtype=torch.long, device=x.device)
    write_idx = torch.where(keep & (gid < n_groups), flat_slot,
                            torch.full_like(flat_slot, rows))
    slot_tok[write_idx] = tok
    x_pad = torch.cat([x, x.new_zeros((1, d))], dim=0)
    buf = x_pad[slot_tok[:rows]].reshape(n_groups, capacity, d)
    return buf, tok, gid, keep, order, flat_slot, counts[:n_groups]


def _combine_gather(y_flat: torch.Tensor, flat_slot: torch.Tensor,
                    order: torch.Tensor, weight: torch.Tensor, T: int, k: int,
                    valid: torch.Tensor) -> torch.Tensor:
    """Gather each assignment's FFN row back and sum per token in fp32.

    y_flat: (rows, d); rows indexed by flat_slot where `valid`, anything else
    reads an appended zero row. Every token has exactly k assignments: they
    return to (T, k, d) through the inverse of the dispatch order and are
    summed over k in a fixed order (no scatter-add, so no atomics).
    """
    rows, d = y_flat.shape
    y_pad = torch.cat([y_flat, y_flat.new_zeros((1, d))], dim=0)
    idx = torch.where(valid, flat_slot, torch.full_like(flat_slot, rows))
    contrib = y_pad[idx].float() * weight[:, None]            # sorted order
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), device=order.device)
    per_tok = contrib[inv].reshape(T, k, d)
    out = per_tok[:, 0]
    for j in range(1, k):
        out = out + per_tok[:, j]
    return out


def slot_ffn_row_counts(counts: torch.Tensor, slot_of_expert: torch.Tensor,
                        capacity: int) -> torch.Tensor:
    """The rows of each expert's dispatch buffer that `slot_ffn` computes:
    its assignments (`_dispatch_gather`'s counts) cut to `capacity`, and 0
    where the expert is not resident (slot < 0). (E,) int32 on the device;
    no host read."""
    return torch.where(slot_of_expert >= 0, torch.clamp(counts, max=capacity),
                       0).to(torch.int32)


def moe_slotbuf(params, slot_weights, slot_of_expert: torch.Tensor,
                x: torch.Tensor, moe, capacity: int,
                router_out: Optional[RouterOutput] = None,
                use_kernel: bool = False):
    """MoE compute where expert weights live in a bounded slot buffer.

    slot_weights: dict(w_gate (S, d, f), w_up (S, d, f), w_down (S, f, d));
    `slot_of_expert`: (E,) int32 on x's device, -1 if not resident. Tokens
    routed to a non-resident expert have their gates zeroed and dispatch to
    a dead sentinel slot past the real buffer. Each expert (or slot) takes
    at most `capacity` assignments. `router_out` skips re-routing.

    Two expert paths:
    - bf16 einsum over the slot-grouped buffer (dispatch groups by slot);
    - ``use_kernel=True``: dispatch groups by expert and `slot_ffn` reads
      each expert's weights from its slot (the Hopper kernel on CUDA, its
      plain version on the CPU). It is given each expert's rows that hold
      tokens, built on the device (no host read), with 0 for a
      non-resident expert: the kernel computes only those rows, and a
      non-resident expert's rows are never written, so the combine reads
      a row only where the assignment is kept and resident.
    """
    T, d = x.shape
    E, k = moe.num_experts, moe.top_k
    r = router_out if router_out is not None else route(
        params["router"], x, k, moe.router_norm_topk)
    slot_raw = slot_of_expert.long()[r.expert_ids]              # (T, k)
    resident = slot_raw >= 0
    gates = r.gates * resident.float()

    if not use_kernel:
        out = _slot_sum(slot_weights, slot_raw, resident, gates, x, k,
                        capacity).to(x.dtype)
        return _add_shared(params, x, out), r
    buf, tok, eid, keep, order, flat_slot, counts = _dispatch_gather(
        x, r.expert_ids, E, capacity)
    counts = slot_ffn_row_counts(counts, slot_of_expert, capacity)
    # clamped, so no entry reads outside the buffer
    slot_valid = torch.clamp(slot_of_expert, min=0).to(torch.int32)
    y = slot_ffn(buf, slot_valid, slot_weights["w_gate"],
                 slot_weights["w_up"], slot_weights["w_down"],
                 counts=counts)                                     # (E,C,d)
    weight = gates.reshape(-1)[order] * keep.float()
    valid = keep & resident.reshape(-1)[order]
    out = _combine_gather(y.reshape(E * capacity, d), flat_slot, order,
                          weight, T, k, valid=valid).to(x.dtype)
    return _add_shared(params, x, out), r


def _slot_sum(slot_weights, slot_raw: torch.Tensor, resident: torch.Tensor,
              gates: torch.Tensor, x: torch.Tensor, k: int,
              capacity: int) -> torch.Tensor:
    """`moe_slotbuf`'s einsum path up to its fp32 combine: the bf16
    per-slot FFN over the slot-grouped dispatch buffer, each token's k
    gate-weighted rows summed in fp32. slot_raw (T, k): each assignment's
    slot; resident (T, k): whether it has one; gates (T, k) already zero
    where not resident."""
    T, d = x.shape
    n_slots = slot_weights["w_gate"].shape[0]
    slot_ids = torch.where(resident, slot_raw,
                           torch.full_like(slot_raw, n_slots))
    buf, tok, sid, keep, order, flat_slot, _ = _dispatch_gather(
        x, slot_ids, n_slots, capacity)
    g = torch.bmm(buf, slot_weights["w_gate"])
    u = torch.bmm(buf, slot_weights["w_up"])
    h = F.silu(g) * u
    y = torch.bmm(h, slot_weights["w_down"])
    weight = gates.reshape(-1)[order] * keep.float()
    return _combine_gather(y.reshape(n_slots * capacity, d), flat_slot,
                           order, weight, T, k, valid=keep & (sid < n_slots))


def moe_slotbuf_fused(params, slot_weights, slot_of_expert: torch.Tensor,
                      x: torch.Tensor, moe,
                      logit_bias: Optional[torch.Tensor] = None):
    """Decode-superkernel MoE entry: route + top-k + slot lookup +
    gate-weighted expert FFN in one `fused_moe_entry` call (no dispatch
    buffer: only routed, resident (token, expert) pairs are computed).

    `slot_of_expert`: (E,) int32 on x's device, -1 if not resident;
    `logit_bias`: (E,) fp32 added to the router logits (None: zeros).
    Returns (out (T, d) in x's dtype, gates (T, k) fp32 zeroed for
    non-resident experts, expert ids (T, k) int32). Shared experts are
    added outside the kernel."""
    if logit_bias is None:
        logit_bias = torch.zeros(moe.num_experts, dtype=torch.float32,
                                 device=x.device)
    y, gates, ids = fused_moe_entry(
        x, params["router"], logit_bias, slot_of_expert,
        slot_weights["w_gate"], slot_weights["w_up"], slot_weights["w_down"],
        top_k=moe.top_k, norm_topk=moe.router_norm_topk)
    return _add_shared(params, x, y.to(x.dtype)), gates, ids


def moe_grouped(params, x: torch.Tensor, moe,
                capacity: Optional[int] = None):
    """Capacity-buffer grouped MoE over the layer's own (resident) expert
    weights: the reference's single-device `moe_grouped`, which computes
    exactly the slot path's einsum branch under the identity slot table.
    x: (T, d), or (G, Tg, d) with one dispatch (and capacity) per group.
    Returns (out, router output), the latter over every token (G * Tg
    rows, group-major). On a mesh (x a DTensor) see `_moe_mesh`."""
    mesh = shd.get_mesh()
    if mesh is not None and shd.is_dtensor(x):
        return _moe_mesh(params, x, moe, capacity, mesh)
    if x.dim() == 3:
        outs = [moe_grouped(params, xg, moe, capacity) for xg in x]
        r = RouterOutput(*(torch.cat(f) for f in zip(*(o[1] for o in outs))))
        return torch.stack([o for o, _ in outs]), r
    if capacity is None:
        capacity = max(1, int(x.shape[0] * moe.top_k / moe.num_experts
                              * moe.capacity_factor))
    ident = torch.arange(moe.num_experts, dtype=torch.int32, device=x.device)
    full = {n: params[n] for n in ("w_gate", "w_up", "w_down")}
    return moe_slotbuf(params, full, ident, x, moe, capacity=capacity)


# ---------------------------------------------------------------------------
# Expert-parallel formulation (a mesh)
# ---------------------------------------------------------------------------

def _dsize(mesh, axes) -> int:
    n = 1
    for a in axes:
        n *= shd.axis_size(mesh, a)
    return n


def _fsdp_gather_ok(mesh, fsdp: bool, dim: int) -> bool:
    """FSDP weight all-gather is legal iff `dim` tiles evenly over `data`."""
    return (fsdp and "data" in shd.axis_names(mesh)
            and dim % _dsize(mesh, ("data",)) == 0)


def _can_shard_map(mesh, moe, G, Tg, d) -> bool:
    if mesh is None or "model" not in shd.axis_names(mesh) or Tg <= 1:
        return False
    dsz = _dsize(mesh, shd.batch_axes(mesh))
    return (moe.num_experts % shd.axis_size(mesh, "model") == 0
            and G % max(dsz, 1) == 0)


def _moe_mesh(params, x, moe, capacity, mesh):
    """`moe_grouped` on a mesh. (G, Tg, d) groups that tile the batch axes
    with Tg > 1 take the hand-scheduled expert-parallel layer
    (`_can_shard_map`, as the reference's shard_map); anything else (a
    (T, d) decode batch is one group) first gathers its tokens over the
    batch axes and runs the same local dispatch there, the output sliced
    back to the batch sharding. Shared experts follow as a dense FFN."""
    squeeze = x.dim() == 2
    G, Tg = (1, x.shape[0]) if squeeze else tuple(x.shape[:2])
    d = x.shape[-1]
    if capacity is None:
        capacity = max(1, int(Tg * moe.top_k / moe.num_experts
                              * moe.capacity_factor))
    ep = _can_shard_map(mesh, moe, G, Tg, d)
    xin = x if ep else shd.constrain(x, (None,) * x.dim())
    out, r = _moe_shard_map(params, xin, moe, capacity, mesh)
    out = _add_shared(params, xin, out.to(x.dtype))
    out = shd.constrain(out, ("data",) + (None,) * (x.dim() - 1))
    return out, r


def _moe_shard_map(params, x, moe, capacity, mesh):
    """Hand-scheduled EP MoE: experts sharded over `model` (E / m a rank,
    when E divides), x's groups as x is sharded over the batch axes. The
    collectives are EXACTLY: one weight all-gather over `data` per
    projection when the weights are stored FSDP-sharded, and one fp32
    all-reduce of the layer output over `model`. Each rank routes its own
    tokens (the router is replicated) and dispatches them to its own
    experts only (the others' gates zeroed, their tokens to the dead
    sentinel slot), through the einsum path of `moe_slotbuf`; the fp32
    per-token sums of the ranks add up to the one-device sum. Returns the
    fp32 output and the router output, as DTensors."""
    E, k = moe.num_experts, moe.top_k
    msize = shd.axis_size(mesh, "model")
    sharded = E % msize == 0
    E_loc = E // msize if sharded else E
    e0 = shd.model_rank(mesh) * E_loc if sharded else 0
    # weights stored FSDP-sharded (`_fsdp_gather_ok`: d_model tiles over
    # data) are all-gathered over data once per projection; the expert dim
    # stays over model
    espec = "model" if sharded else None
    ws = [shd.constrain(params[n], (espec, None, None))
          for n in ("w_gate", "w_up", "w_down")]

    def local_fn(router, wg, wu, wd, xb):
        e = torch.arange(E, device=xb.device) - e0
        slot_map = torch.where((e >= 0) & (e < E_loc), e,
                               torch.full_like(e, -1))
        w = {"w_gate": wg, "w_up": wu, "w_down": wd}
        outs, rs = [], []
        for xg in ([xb] if xb.dim() == 2 else list(xb)):
            r = route(router, xg, k, moe.router_norm_topk)
            slot_raw = slot_map[r.expert_ids]
            resident = slot_raw >= 0
            outs.append(_slot_sum(w, slot_raw, resident,
                                  r.gates * resident.float(), xg, k,
                                  capacity))
            rs.append(r)
        out = outs[0] if xb.dim() == 2 else torch.stack(outs)
        return out, RouterOutput(*(torch.cat(f) for f in zip(*rs)))

    return shd.region(local_fn, params["router"], *ws, x, like=x,
                      out=(shd.Out((shd.BATCH,), partial=sharded),
                           shd.Out((shd.BATCH,))))
