"""A configuration file as the program runs it: the port's `ModelConfig`,
checked key by key against the file's published keys, and the seeded
weights in the layout `SlotBufferEngine` takes."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

from reference import model as ref_model
from reference.weights import Leaf, depth_of, make_all

# published key -> ModelConfig field (dotted into its sub-configs)
PUBLISHED = {
    "hidden_size": "d_model",
    "num_hidden_layers": "num_layers",
    "num_attention_heads": "num_heads",
    "num_key_value_heads": "num_kv_heads",
    "vocab_size": "vocab_size",
    "rms_norm_eps": "norm_eps",
    "rope_theta": "rope_theta",
    "tie_word_embeddings": "tie_embeddings",
    "torch_dtype": "dtype",
    "num_experts": "moe.num_experts",
    "n_routed_experts": "moe.num_experts",
    "num_experts_per_tok": "moe.top_k",
    "norm_topk_prob": "moe.router_norm_topk",
    "n_shared_experts": "moe.num_shared_experts",
    "first_k_dense_replace": "moe.first_dense_layers",
    "moe_intermediate_size": "moe.d_expert",
    "kv_lora_rank": "mla.kv_lora_rank",
    "qk_nope_head_dim": "mla.qk_nope_head_dim",
    "qk_rope_head_dim": "mla.qk_rope_head_dim",
    "v_head_dim": "mla.v_head_dim",
}


def _get(cfg, field: str):
    for part in field.split("."):
        cfg = getattr(cfg, part)
    return cfg


def _set(cfg, field: str, value):
    head, _, rest = field.partition(".")
    if not rest:
        return dataclasses.replace(cfg, **{head: value})
    return dataclasses.replace(cfg, **{head: _set(getattr(cfg, head), rest,
                                                  value)})


def port_config(conf: dict):
    """The port's registry config of `conf["as_run"]["registry"]`, with
    `as_run.overrides` (ModelConfig fields, dotted) applied; raises where
    a published key of the file disagrees with what the program runs."""
    from repro_torch.configs.registry import get_config
    as_run = conf["as_run"]
    cfg = get_config(as_run["registry"])
    for field, value in as_run.get("overrides", {}).items():
        cfg = _set(cfg, field, value)
    pairs = dict(PUBLISHED)
    # without a separate expert width, `intermediate_size` is the expert's
    pairs["intermediate_size"] = ("d_ff" if "moe_intermediate_size" in conf
                                  else "moe.d_expert")
    wrong = []
    for key, field in pairs.items():
        if key in conf and conf[key] is not None:
            have = _get(cfg, field)
            if (conf[key] != have if isinstance(have, (bool, str))
                    else float(conf[key]) != float(have)):
                wrong.append(f"{key}={conf[key]!r} but {field}={have!r}")
    if conf.get("n_shared_experts") and \
            cfg.moe.d_shared != cfg.moe.d_expert:
        wrong.append("a shared expert is not as wide as a routed one")
    if wrong:
        raise ValueError(f"{conf['name']}: the program would not run the "
                         f"file's model: {'; '.join(wrong)}")
    return cfg


def flat_layout(tree, prefix: str = "") -> List[Leaf]:
    if isinstance(tree, dict):
        return [l for k, v in tree.items()
                for l in flat_layout(v, prefix + k + ".")]
    if isinstance(tree, list):
        return [l for i, v in enumerate(tree)
                for l in flat_layout(v, prefix + f"{i}.")]
    return [(prefix[:-1], tuple(tree.shape), tree.dtype)]


def program_layout(cfg) -> List[Leaf]:
    """The leaves of the program's parameter tree, by name, shape and
    dtype (`Model.init` on the meta device: no values)."""
    from repro_torch.models.transformer import Model
    return flat_layout(Model(cfg).init(device="meta"))


def check_layout(conf: dict, cfg) -> List[Leaf]:
    """The program's layout, which has to be the reference's leaf for
    leaf: the two sides draw the same weights by name."""
    mine = sorted(program_layout(cfg))
    ref = sorted(ref_model.layout(ref_model.arch_of(conf)))
    if mine != ref:
        only_p = sorted(set(mine) - set(ref))[:4]
        only_r = sorted(set(ref) - set(mine))[:4]
        raise ValueError(f"{conf['name']}: the program's parameters and the "
                         f"reference's differ: program {only_p}, reference "
                         f"{only_r}")
    return mine


def make_params(seed: int, layout: List[Leaf], device) -> Dict[str, Any]:
    """The seeded weights as the program's parameter tree: the model's
    own tensors at the top, one dict a layer under "layers"."""
    flat = make_all(seed, layout, device)
    tree: Dict[str, Any] = {"layers": [{} for _ in range(depth_of(layout))]}
    for path, t in flat.items():
        parts = path.split(".")
        node = tree
        if parts[0] == "layers":
            node, parts = tree["layers"][int(parts[1])], parts[2:]
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = t
    return tree


def active_flops_per_token(conf: dict) -> float:
    """Matrix-product FLOPs one token takes outside attention's scores:
    twice every weight it multiplies (the projections, the dense FFN, its
    top k routed experts and the shared ones, the router, the LM head; not
    the embedding lookup or the norms)."""
    a = ref_model.arch_of(conf)
    n = 0
    for path, shape, _ in ref_model.layout(a):
        if path == "embed" or len(shape) == 1:
            continue
        size = 1
        for s in shape:
            size *= s
        if ".moe.w_" in path:
            size = size // a.experts * a.top_k
        n += size
    return 2.0 * n


def attention_flops(conf: dict, context: int) -> float:
    """FLOPs of one token's attention scores and weighted sum over
    `context` keys, summed over the layers."""
    a = ref_model.arch_of(conf)
    if a.mla:
        _, nope, rope_d, v = a.mla
        per = 2 * context * a.heads * (nope + rope_d + v)
    else:
        per = 4 * context * a.heads * a.head_dim
    return float(per * a.layers)
