"""Smoke-size cells for the CPU tests: the two served architectures at
the port's smoke widths, and small mixes of both kinds."""
import copy
import json
import time
from pathlib import Path

import run

ROOT = Path(__file__).resolve().parents[2]

OLMOE = {
    "name": "olmoe-smoke", "hidden_size": 64, "intermediate_size": 32,
    "num_hidden_layers": 2, "num_attention_heads": 4,
    "num_key_value_heads": 4, "num_experts": 8, "num_experts_per_tok": 2,
    "norm_topk_prob": False, "rms_norm_eps": 1e-5, "rope_theta": 10000.0,
    "vocab_size": 512, "torch_dtype": "bfloat16", "n_slots_per_layer": 4,
    "as_run": {"registry": "olmoe-1b-7b", "qk_norm": "per_head",
               "overrides": {"num_layers": 2, "d_model": 64, "num_heads": 4,
                             "num_kv_heads": 4, "vocab_size": 512,
                             "moe.num_experts": 8, "moe.top_k": 2,
                             "moe.d_expert": 32, "norm_eps": 1e-5}}}

DEEPSEEK = {
    "name": "deepseek-smoke", "hidden_size": 64, "intermediate_size": 128,
    "moe_intermediate_size": 32, "first_k_dense_replace": 1,
    "kv_lora_rank": 32, "qk_nope_head_dim": 16, "qk_rope_head_dim": 8,
    "v_head_dim": 16, "q_lora_rank": None, "n_routed_experts": 8,
    "n_shared_experts": 2, "num_experts_per_tok": 2, "norm_topk_prob": False,
    "num_hidden_layers": 3, "num_attention_heads": 4,
    "num_key_value_heads": 4, "rms_norm_eps": 1e-6, "rope_theta": 10000,
    "rope_scaling": None, "vocab_size": 512, "torch_dtype": "bfloat16",
    "n_slots_per_layer": 4,
    "as_run": {"registry": "deepseek-v2-lite",
               "overrides": {"num_layers": 3, "d_model": 64, "num_heads": 4,
                             "num_kv_heads": 4, "vocab_size": 512,
                             "d_ff": 128, "moe.num_experts": 8,
                             "moe.top_k": 2, "moe.d_expert": 32,
                             "moe.d_shared": 32,
                             "moe.router_norm_topk": False,
                             "mla.kv_lora_rank": 32,
                             "mla.qk_nope_head_dim": 16,
                             "mla.qk_rope_head_dim": 8,
                             "mla.v_head_dim": 16}}}

DECODE_MIX = {
    "order_seed": 26, "requests": 200, "arrival": {"kind": "backlog"},
    "prompt_len": {"dist": "lognormal", "median": 16, "sigma": 0.5,
                   "min": 8, "max": 32},
    "output_len": {"dist": "lognormal", "median": 14, "sigma": 0.5,
                   "min": 8, "max": 24},
    "max_batch": 4, "max_seq": 64, "prefill_chunk": 8,
    "window": {"opens": "all_decoding"}}

LONGPROMPT_MIX = dict(
    DECODE_MIX,
    prompt_len={"dist": "lognormal", "median": 40, "sigma": 0.5, "min": 24,
                "max": 56},
    output_len={"dist": "lognormal", "median": 4, "sigma": 0.5, "min": 2,
                "max": 6},
    window={"opens": "first_decode"})


def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell(model: str = "olmoe", mix: str = None) -> "run.Cell":
    """The manifest's cell `olmoe.decode` with a model at smoke size
    (`model`: "olmoe", or "deepseek" for MLA, shared experts and a dense
    layer), its mix small (the decode mix, or with `mix="longprompt"` the
    long-prompt one), its limits as committed."""
    c = run.Cell(manifest(), "olmoe.decode")
    c.conf = copy.deepcopy(DEEPSEEK if model == "deepseek" else OLMOE)
    c.mix = copy.deepcopy(LONGPROMPT_MIX if mix == "longprompt"
                          else DECODE_MIX)
    return c


def run_smoke(model: str = "olmoe", seed: int = 2 ** 33 + 5,
              seconds: float = 3.0, trace: bool = False, c=None):
    c = c or cell(model)
    return run.run_cell(c, seed, seconds, trace, device="cpu",
                        t_start=time.perf_counter())
