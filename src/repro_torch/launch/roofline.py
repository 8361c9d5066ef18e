"""Roofline terms of a step, from a run on fake tensors.

The reference reads XLA's cost analysis of compiled steps, which counts
each loop body once, so it corrects with standalone per-layer compiles and
flash-block counts. The port runs the step itself, eagerly, on fake
tensors over a fake process group (`launch.dryrun`): nothing is computed
and nothing moves, but every op runs with the shapes one device would see,
every layer and every loop iteration included. `lower_cost` counts, per
device:

- FLOPs with `torch.utils.flop_counter`'s per-op formulas (those of
  `FlopCounterMode`: matmuls, convolutions, attention);
- bytes by XLA's "bytes accessed" convention: each op's operand bytes
  plus its result bytes (views move nothing and count nothing);
- collectives with `launch.hlo`'s recorder.

A DTensor op is counted through the local ops it runs (its per-device
shapes). The kernels' fake device is the CPU, so each kernel is counted
through its plain version.

The components (one per distinct layer kind, times its count, plus the
head and the optimizer) are kept for the breakdown; since nothing is
under-counted they should sum to the full step (tested on a smoke config).
`flash_block_cost` and `_n_blocks` keep the reference's arithmetic and
feed the dry run's `flash_blocks` entry (the block geometry), not the
sums.

Terms per device, on the H100's data-sheet rates (`PLATFORMS["h100"]` of
`simulator/hardware.py`: 989e12 dense bf16 FLOP/s, 3.35e12 B/s HBM3); the
collective rate is InfiniBand NDR's 400 Gb/s = 50e9 B/s a GPU, the
inter-node link of every rank of a 16x16 mesh of H100s (32 eight-GPU
nodes). Every term is modeled, none measured.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Tuple

import torch
from torch.utils.flop_counter import flop_registry

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import ShapeCell
from repro_torch.distributed import sharding as shd
from repro_torch.launch import hlo
from repro_torch.launch.hlo import CollectiveStats
from repro_torch.launch.specs import _cache_sharding, _fake, _put
from repro_torch.models.transformer import (ENCODER_SPEC, LayerSpec, Model,
                                            init_layer, init_layer_cache,
                                            layer_decode, layer_forward)
from repro_torch.simulator.hardware import PLATFORMS
from repro_torch.training.loss import chunked_cross_entropy
from repro_torch.training.optimizer import adamw_init, adamw_update
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

PEAK_FLOPS = PLATFORMS["h100"].flops      # 989e12 dense bf16
HBM_BW = PLATFORMS["h100"].hbm_bw         # 3.35e12 B/s
ICI_BW = 50e9                             # InfiniBand NDR, 400 Gb/s a GPU

Q_CHUNK, KV_CHUNK = 512, 1024   # must match models/attention.py defaults
CE_CHUNK = 512                  # the train CLI's and the dry run's


@dataclass
class Component:
    name: str
    count: float
    flops: float            # per instance, per device
    bytes: float
    coll_bytes: float
    coll_by_kind: Dict[str, int] = field(default_factory=dict)

    @property
    def total_flops(self) -> float:
        return self.count * self.flops

    @property
    def total_bytes(self) -> float:
        return self.count * self.bytes

    @property
    def total_coll(self) -> float:
        return self.count * self.coll_bytes


def _tensor_bytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_tensor_bytes(y) for y in x)
    return 0


class CostMode(hlo.CollectiveRecorder):
    """Per-device FLOPs, bytes accessed and collectives of the ops run
    inside it (see the module docstring); a DTensor op defers to its local
    ops."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not hlo.all_plain(types):
            return NotImplemented
        self.note(func, args)
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if not func.is_view and func.namespace == "aten":
            self.bytes += _tensor_bytes(list(args)) + \
                _tensor_bytes(list(kwargs.values())) + _tensor_bytes(out)
        return out


def lower_cost(fn: Callable, *args) -> Tuple[float, float, CollectiveStats]:
    """(FLOPs, bytes accessed, collectives) per device of fn(*args)."""
    with CostMode() as cost:
        fn(*args)
    return float(cost.flops), float(cost.bytes), hlo.collective_stats(cost)


def _msize(mesh, axes) -> int:
    n = 1
    for a in axes:
        n *= shd.axis_size(mesh, a)
    return max(n, 1)


def _n_blocks(T_q: int, S_kv: int, causal: bool = True,
              window: int = 0) -> int:
    """ACTIVE flash blocks (the kernel skips fully-masked kv blocks)."""
    qc = min(Q_CHUNK, T_q)
    kc = min(KV_CHUNK, S_kv)
    nq = -(-T_q // qc)
    nk = -(-S_kv // kc)
    if not causal and window <= 0:
        return nq * nk
    n = 0
    for qi in range(nq):
        q_lo, q_hi = qi * qc, qi * qc + qc - 1
        for ki in range(nk):
            k_lo, k_hi = ki * kc, ki * kc + kc - 1
            if causal and k_lo > q_hi:
                continue
            if window > 0 and k_hi <= q_lo - window:
                continue
            n += 1
    return n


def flash_block_cost(cfg: ModelConfig, mesh, B: int, S_kv: int,
                     train: bool) -> Tuple[float, float, float, float]:
    """Cost of ONE flash (q_chunk x kv_chunk) block on one device: its
    batch rows over the batch axes, its heads over ``model`` where they
    divide. Returns (flops_fwd, bytes_fwd, flops_bwd, bytes_bwd); the
    backward's includes its own forward. Call under a fake-tensor mode."""
    hd = cfg.resolved_head_dim
    Dk = Dv = hd
    if cfg.attention == "mla" and cfg.mla is not None:
        Dk = cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim
        Dv = cfg.mla.v_head_dim
    Hkv = cfg.num_kv_heads if cfg.attention != "mla" else cfg.num_heads
    G = cfg.num_heads // Hkv
    qc, kc = min(Q_CHUNK, S_kv), min(KV_CHUNK, S_kv)
    m = shd.axis_size(mesh, "model")
    h = Hkv // m if Hkv % m == 0 else Hkv
    g = G // m if Hkv % m and G % m == 0 else G
    nb = _msize(mesh, shd.batch_axes(mesh))
    b = B // nb if B % nb == 0 else B

    def block(q, k, v, acc, mx, l):
        s = torch.einsum("bqhgd,bkhd->bhgqk", q, k.float())
        m_new = torch.maximum(mx, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(mx - m_new)
        l_new = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bhgqk,bkhd->bhgqd", p, v.float())
        return acc * corr[..., None] + pv, m_new, l_new

    def t(*s, dt=torch.float32, grad=False):
        return torch.empty(s, dtype=dt).requires_grad_(grad)

    args = (t(b, qc, h, g, Dk, grad=train),
            t(b, kc, h, Dk, dt=torch.bfloat16, grad=train),
            t(b, kc, h, Dv, dt=torch.bfloat16, grad=train),
            t(b, h, g, qc, Dv), t(b, h, g, qc), t(b, h, g, qc))
    with torch.no_grad():
        f_fwd, b_fwd, _ = lower_cost(block, *args)
    f_bwd = b_bwd = 0.0
    if train:
        def block_grad(*a):
            out = block(*a)
            torch.autograd.grad(sum(o.float().sum() for o in out), a[:3])
        f_bwd, b_bwd, _ = lower_cost(block_grad, *args)
    return f_fwd, b_fwd, f_bwd, b_bwd


def _unique_specs(model: Model) -> List[Tuple[LayerSpec, int]]:
    """Distinct LayerSpecs with their occurrence counts over the depth."""
    seen: Dict[Tuple, List] = {}
    for s in model.specs:
        k = (s.kind, s.window, s.is_moe)
        seen.setdefault(k, [s, 0])
        seen[k][1] += 1
    return [(v[0], v[1]) for v in seen.values()]


def _geometry(cfg: ModelConfig, cell: ShapeCell, kind: str):
    """(encoder length, decoder length) of a cell's sequences."""
    S = cell.seq_len
    if cfg.is_encoder_decoder:
        enc_len = min(cfg.max_source_positions * 2, max(S // 2, 8))
        dec_len = max(S - enc_len, 8) if kind == "train" else min(S, 448)
        if kind == "prefill":
            enc_len, dec_len = S, 448
        return enc_len, dec_len
    return 0, S


def _abstract_layer(model: Model, spec: LayerSpec, mesh, fsdp: bool,
                    with_cross: bool = True):
    """One layer's params as fake DTensors with the production layout (a
    one-layer tree, so the rules see the same key paths)."""
    lp = init_layer(model.cfg, spec, model.dtype, device="meta",
                    with_cross=with_cross)
    return shd.distribute_params({"layers": [tree_map(_fake, lp)]}, mesh,
                                 fsdp=fsdp)["layers"][0]


def _act(shape, mesh, B, dt=torch.bfloat16):
    return _put(torch.empty(shape, dtype=dt),
                shd.batch_sharding(mesh, len(shape), 0, B))


def _grad_of(fn, params, *inputs):
    """fn forward, then its backward into the params and inputs[0]."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    x = inputs[0].detach().requires_grad_(True)
    out = fn(tree_unflatten(params, leaves), x, *inputs[1:])
    torch.autograd.grad(out.float().sum(), leaves + [x], allow_unused=True)


def component_costs(model: Model, cfg: ModelConfig, cell: ShapeCell, mesh,
                    kind: str) -> List[Component]:
    """Cost components of one cell's step, per device. Call under a
    fake-tensor mode and the cell's mesh context."""
    B, S = cell.global_batch, cell.seq_len
    train = kind == "train"
    comps: List[Component] = []
    d = cfg.d_model
    enc_len, dec_len = _geometry(cfg, cell, kind)
    T = dec_len if kind != "decode" else 1

    x_abs = _act((B, T, d), mesh, B)
    pos = _act((B, T), mesh, B, dt=torch.long)
    enc = {}
    if cfg.is_encoder_decoder and kind != "decode":
        enc = {"enc_out": _act((B, enc_len, d), mesh, B),
               "enc_pos": _act((B, enc_len), mesh, B, dt=torch.long)}

    def add(name, count, fn, *args, train_grad=False):
        """A component from fn(*args); with `train_grad` also the backward
        (`_grad_of`), as a remat step runs it: the forward, then the
        forward again and the backward."""
        with torch.no_grad():
            f, b, c = lower_cost(fn, *args)
        if train_grad:
            f2, b2, c2 = lower_cost(_grad_of, fn, *args)
            f, b, c = f + f2, b + b2, c.merged(c2)
            name += "(train)"
        comps.append(Component(name, count, f, b, c.total_bytes,
                               c.bytes_by_kind))

    for spec, count in _unique_specs(model):
        lp = _abstract_layer(model, spec, mesh, fsdp=train)
        name = f"layer[{spec.kind}{'/moe' if spec.is_moe else ''}" \
               f"{f'/w{spec.window}' if spec.window else ''}]"
        if kind == "decode":
            src = cfg.max_source_positions if cfg.is_encoder_decoder else 0
            cache = tree_map(
                lambda t: _put(_fake(t), _cache_sharding(
                    mesh, tuple(t.shape), B) if t.dim() >= 2
                    else shd.replicated(mesh, t.dim())),
                init_layer_cache(cfg, spec, B, S, model.dtype, "meta", src))
            clen = _put(torch.zeros((), dtype=torch.long),
                        shd.replicated(mesh))
            add(name, count, lambda p, x, c, n: layer_decode(
                p, cfg, spec, x, c, n, use_kernel=True, src_len=src or None),
                lp, x_abs, cache, clen)
            continue

        def fwd(p, x, pos_=pos):
            return layer_forward(p, cfg, spec, x, pos_, **enc)

        add(name, count, fwd, lp, x_abs, train_grad=train)

    # encoder stack (whisper)
    if cfg.is_encoder_decoder and kind != "decode":
        lp = _abstract_layer(model, ENCODER_SPEC, mesh, fsdp=train,
                             with_cross=False)
        xe = _act((B, enc_len, d), mesh, B)
        pe = _act((B, enc_len), mesh, B, dt=torch.long)

        def enc_fn(p, x, pos_=pe):
            return layer_forward(p, cfg, ENCODER_SPEC, x, pos_, causal=False)

        add("enc_layer", cfg.encoder_layers, enc_fn, lp, xe,
            train_grad=train)

    # head: the chunked cross-entropy (train) or last-position logits
    V = cfg.vocab_size
    w = _put(torch.empty((d, V), dtype=model.dtype), shd.sharding_of(
        mesh, ("data" if train else None, "model"), (d, V)))
    if train:
        def ce_grad(h, w_, y_):
            w2 = w_.detach().requires_grad_(True)
            h2 = h.detach().requires_grad_(True)
            loss = chunked_cross_entropy(
                h2, w2, y_, chunk=CE_CHUNK,
                logit_softcap=cfg.final_logit_softcap)
            torch.autograd.grad(loss, [h2, w2])

        f, by, c = lower_cost(ce_grad, _act((B, T, d), mesh, B), w,
                              _act((B, T), mesh, B, dt=torch.long))
        comps.append(Component("ce_head(train)", 1, f, by, c.total_bytes,
                               c.bytes_by_kind))
    else:
        head = {"final_norm": _put(torch.empty((d,), dtype=model.dtype),
                                   shd.replicated(mesh, 1))}
        if cfg.tie_embeddings:
            head["embed"] = w.T
        else:
            head["lm_head"] = w
        add("head", 1, model.logits, head, _act((B, d), mesh, B))

    # optimizer update (train): pointwise over all params
    if train:
        from repro_torch.launch.specs import abstract_params
        p_abs = abstract_params(model, mesh, fsdp=True)
        o_abs = adamw_init(p_abs)
        add("optimizer", 1, lambda g, o, p: adamw_update(g, o, p), p_abs,
            o_abs, p_abs)
    return comps


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    components: List[Component]
    model_flops_global: float
    raw_flops: float = 0.0          # the full step, per device
    raw_bytes: float = 0.0
    raw_coll_bytes: float = 0.0
    peak_memory_bytes: float = 0.0
    compile_seconds: float = 0.0    # the fake run's seconds
    min_bytes_per_device: float = 0.0   # analytic perfect-fusion floor
    # collective bytes of the full step; the port records every
    # collective each time it runs, so this is its loop-aware count
    loop_coll_bytes: float = -1.0

    @property
    def flops_per_device(self) -> float:
        return sum(c.total_flops for c in self.components)

    @property
    def bytes_per_device(self) -> float:
        return sum(c.total_bytes for c in self.components)

    @property
    def coll_bytes_per_device(self) -> float:
        return sum(c.total_coll for c in self.components)

    @property
    def compute_term_s(self) -> float:
        return self.flops_per_device / PEAK_FLOPS

    @property
    def memory_term_s(self) -> float:
        """Upper bound: 'bytes accessed' assumes nothing fuses."""
        return self.bytes_per_device / HBM_BW

    @property
    def memory_term_min_s(self) -> float:
        """Lower bound: analytic perfect-fusion HBM traffic."""
        return self.min_bytes_per_device / HBM_BW

    @property
    def collective_term_s(self) -> float:
        src = self.loop_coll_bytes if self.loop_coll_bytes >= 0 \
            else self.coll_bytes_per_device
        return src / ICI_BW

    @property
    def dominant(self) -> str:
        """Bottleneck classification uses the analytic memory floor — the
        byte upper bound would label EVERYTHING memory-bound."""
        terms = {"compute": self.compute_term_s,
                 "memory": self.memory_term_min_s,
                 "collective": self.collective_term_s}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        total = self.flops_per_device * self.chips
        return self.model_flops_global / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """compute term / max(compute, memory-floor, collective):
        1.0 = perfectly compute-bound."""
        bound = max(self.compute_term_s, self.memory_term_min_s,
                    self.collective_term_s)
        return self.compute_term_s / bound if bound else 0.0

    def to_dict(self) -> Dict[str, Any]:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "compute_term_s": self.compute_term_s,
            "memory_term_s": self.memory_term_s,
            "memory_term_min_s": self.memory_term_min_s,
            "collective_term_s": self.collective_term_s,
            "dominant": self.dominant,
            "model_flops_global": self.model_flops_global,
            "hlo_flops_global": self.flops_per_device * self.chips,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "raw_flops_per_device": self.raw_flops,
            "raw_bytes_per_device": self.raw_bytes,
            "raw_coll_bytes_per_device": self.raw_coll_bytes,
            "loop_coll_bytes_per_device": self.loop_coll_bytes,
            "component_coll_bytes_per_device": self.coll_bytes_per_device,
            "peak_memory_bytes": self.peak_memory_bytes,
            "compile_seconds": self.compile_seconds,
            "components": [
                {"name": c.name, "count": c.count, "flops": c.flops,
                 "bytes": c.bytes, "coll_bytes": c.coll_bytes}
                for c in self.components],
        }


def analytic_min_bytes(cfg: ModelConfig, cell: ShapeCell,
                       chips: int) -> float:
    """Lower-bound per-device HBM traffic for one step (perfect fusion):
    - weights are read once per use (train: fwd + remat-fwd + bwd = 3 reads
      + fp32 grad write + optimizer m/v read+write + param write);
    - activations: ~2 residual-stream tensors per layer boundary;
    - decode: only ACTIVE expert weights + the KV cache are read.
    """
    P = cfg.param_count()
    Pa = cfg.active_param_count()
    L = max(cfg.num_layers, 1)
    d = cfg.d_model
    if cell.kind == "train":
        tokens_dev = cell.global_batch * cell.seq_len / chips
        w = P / chips * (3 * 2 + 4 + 16 + 2)     # reads + grads + adam + write
        acts = tokens_dev * d * L * 2 * 6        # fwd save + bwd reread etc.
        return w + acts
    if cell.kind == "prefill":
        tokens_dev = cell.global_batch * cell.seq_len / chips
        w = P / chips * 2
        acts = tokens_dev * d * L * 2 * 3
        kv = tokens_dev * cfg.num_kv_heads * cfg.resolved_head_dim * 2 * L * 2
        return w + acts + kv
    # decode: one token per sequence
    toks_dev = max(cell.global_batch / chips, cell.global_batch / chips)
    w = Pa / chips * 2
    hd = cfg.resolved_head_dim
    if cfg.attention == "mla" and cfg.mla is not None:
        kv_row = cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim
    else:
        kv_row = cfg.num_kv_heads * hd * 2
    n_attn = sum(1 for i in range(L) if cfg.layer_kind(i) == "attn")
    ctx = min(cell.seq_len, max(cfg.window_size, 0) or cell.seq_len)
    kv = cell.global_batch * ctx * kv_row * n_attn * 2 / chips
    return w + kv + toks_dev * d * L * 2 * 3


def model_flops(cfg: ModelConfig, cell: ShapeCell) -> float:
    """MODEL_FLOPS: 6*N*D for train (N=active params), 2*N*D for inference."""
    n_active = cfg.active_param_count()
    if cell.kind == "train":
        tokens = cell.global_batch * cell.seq_len
        return 6.0 * n_active * tokens
    if cell.kind == "prefill":
        tokens = cell.global_batch * cell.seq_len
        return 2.0 * n_active * tokens
    tokens = cell.global_batch  # one token per sequence
    return 2.0 * n_active * tokens
