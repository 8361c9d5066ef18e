"""The port's plain `Model` API (`forward`, `logits`, `prefill`,
`init_cache`, `decode_step`) against the reference's on bridged params, for
every arch the port runs, at smoke sizes, in f32: hidden states, logits,
prefill logits, every cache and 4 decode steps within 1e-4, free-running
(one module-scoped JAX run per arch; bf16 in
`test_torch_model_api_bf16.py`). gemma2's smoke window is 16 rows: the
16-token prompt fills its ring and the 4 decode steps wrap it;
recurrentgemma's recurrent states and xlstm's mLSTM / sLSTM states are
caches like the others; whisper decodes over its encoder's output of 24
random frames (the reference test's source length). Then the reference's
own model contracts (`tests/test_models.py`) on the port.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as jax_smoke
from repro.models import transformer as jax_tf
from repro_torch.bridge import params_from_reference, to_tensor, unstack_layers
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.models import Model, transformer
from repro_torch.tree import leaves_with_paths

B, T, STEPS = 2, 16, 4
MAX_SEQ = T + 8
SRC = 24        # whisper's source frames
DENSE = ["yi-9b", "command-r-plus-104b", "minicpm3-4b", "gemma2-9b",
         "llava-next-34b", "recurrentgemma-2b", "xlstm-1.3b",
         "whisper-large-v3"]


def _cfgs(arch, dtype):
    return (dataclasses.replace(jax_smoke(arch), dtype=dtype),
            dataclasses.replace(get_smoke_config(arch), dtype=dtype))


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else _np(x)


def _ref_inputs(jcfg, jm):
    rng = np.random.default_rng(11)
    toks = rng.integers(0, jcfg.vocab_size, (B, T)).astype(np.int32)
    embeds = frames = None
    if jcfg.uses_input_embeds:
        embeds = np.asarray(jnp.asarray(
            rng.standard_normal((B, T + STEPS, jcfg.d_model)) * 0.5,
            jm.dtype))
    if jcfg.is_encoder_decoder:
        frames = np.asarray(jnp.asarray(
            rng.standard_normal((B, SRC, jcfg.d_model)), jm.dtype))
    return toks, embeds, frames


@pytest.fixture(scope="module", params=ARCH_IDS)
def run32(request):
    """The reference's Model API in f32 on one arch: forward, logits,
    prefill, 4 greedy decode steps; and the port's params bridged from
    its."""
    arch = request.param
    jcfg, tcfg = _cfgs(arch, "float32")
    jm = jax_tf.Model(jcfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(7))
    tree = jax.tree.map(np.asarray, params)
    toks, embeds, frames = _ref_inputs(jcfg, jm)
    enc = {}
    if frames is not None:
        enc_out = jax.jit(jm.encode)(params, jnp.asarray(frames))
        enc = {"enc_out": enc_out}
    kw = (lambda n: {"embeds": jnp.asarray(embeds[:, :n])}) if embeds \
        is not None else (lambda n: dict(enc))
    inp = (lambda n: None) if embeds is not None else \
        (lambda n: jnp.asarray(toks[:, :n]))
    h = jax.jit(lambda p, t, **k: jm.forward(p, t, **k))(params, inp(T),
                                                         **kw(T))
    logits = jax.jit(jm.logits)(params, h)
    lp, cache = jax.jit(lambda p, t, **k: jm.prefill(
        p, t, max_seq=MAX_SEQ, **k))(params, inp(T), **kw(T))
    out = {"h": _np(h), "logits": _np(logits), "prefill": _np(lp),
           "cache": jax.tree.map(np.asarray, cache)}
    dec = jax.jit(jm.decode_step)
    steps, c, nxt = [], cache, jnp.argmax(lp, -1).astype(jnp.int32)
    fed = []
    for i in range(STEPS):
        tok = jnp.asarray(embeds[:, T + i]) if embeds is not None else nxt
        fed.append(np.asarray(tok))
        ld, c = dec(params, tok, c)
        steps.append(_np(ld))
        nxt = jnp.argmax(ld, -1).astype(jnp.int32)
    src = SRC if frames is not None else 0
    want0, _ = dec(params, jnp.asarray(fed[0]), jm.init_cache(B, MAX_SEQ,
                                                              src))
    out.update(steps=steps, fed=fed, toks=toks, embeds=embeds,
               frames=frames, src_len=src,
               enc_out=None if frames is None else _np(enc["enc_out"]),
               last_cache=jax.tree.map(np.asarray, c), from_empty=_np(want0))
    return arch, tcfg, tree, params_from_reference(tree), out


def _port_inputs(out, n, m=None, params=None):
    """The port's inputs for the first n positions; whisper's also carry
    the port's encoder output of the reference's frames (`m.encode`)."""
    if out["embeds"] is not None:
        return {"embeds": to_tensor(out["embeds"][:, :n])}
    inp = {"tokens": torch.as_tensor(out["toks"][:, :n]).long()}
    if out["frames"] is not None:
        inp["enc_out"] = m.encode(params, to_tensor(out["frames"]))
    return inp


def test_params_have_the_reference_tree(run32):
    """`Model.init` makes the reference's tree (bridged): the same keys and
    shapes; tied models have no lm_head, gemma2 its post-norms."""
    arch, cfg, tree, ported, out = run32
    mine = Model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    want = {k: tuple(v.shape) for k, v in leaves_with_paths(ported)}
    got = {k: tuple(v.shape) for k, v in leaves_with_paths(mine)}
    assert got == want
    assert ("lm_head" in mine) == (not cfg.tie_embeddings)
    if cfg.attn_logit_softcap:
        assert {"post_attn_norm", "post_ffn_norm"} <= set(mine["layers"][0])


def test_forward_hidden_and_logits_match(run32):
    arch, cfg, tree, ported, out = run32
    m = Model(cfg)
    with torch.no_grad():
        inp = _port_inputs(out, T, m, ported)
        h = m.forward(ported, inp.get("tokens"), embeds=inp.get("embeds"),
                      enc_out=inp.get("enc_out"))
        logits = m.logits(ported, h)
    if out["enc_out"] is not None:
        np.testing.assert_allclose(_t(inp["enc_out"]), out["enc_out"],
                                   rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_t(h), out["h"], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_t(logits), out["logits"], rtol=1e-4,
                               atol=1e-4)


def test_prefill_logits_and_caches_match(run32):
    arch, cfg, tree, ported, out = run32
    m = Model(cfg)
    with torch.no_grad():
        inp = _port_inputs(out, T, m, ported)
        lp, cache = m.prefill(ported, inp.get("tokens"),
                              embeds=inp.get("embeds"), max_seq=MAX_SEQ,
                              enc_out=inp.get("enc_out"))
    np.testing.assert_allclose(_t(lp), out["prefill"], rtol=1e-4, atol=1e-4)
    want = unstack_layers(out["cache"])
    assert int(cache["len"]) == int(out["cache"]["len"]) == T
    assert len(cache["layers"]) == len(want) == cfg.num_layers
    for mine, ref in zip(cache["layers"], want):
        assert set(mine) == set(ref)
        for name in ref:
            assert tuple(mine[name].shape) == ref[name].shape
            np.testing.assert_allclose(_t(mine[name]), _np(ref[name]),
                                       rtol=1e-4, atol=1e-4)


def _plain_decode_step(m, params, token, cache):
    """`Model.decode_step` with each layer's plain attention
    (`layer_decode(use_kernel=False)`) in place of its decode kernel."""
    pos = cache["len"].reshape(-1, 1).expand(token.shape[0], 1)
    x = m.embed(params, token[:, None], positions=pos) if token.dim() == 1 \
        else token[:, None, :]
    new = []
    for p, spec, c in zip(params["layers"], m.specs, cache["layers"]):
        x, c2 = transformer.layer_decode(p, m.cfg, spec, x, c, cache["len"],
                                         use_kernel=False)
        new.append(c2)
    return m.logits(params, x[:, 0]), {"layers": new,
                                       "len": cache["len"] + 1}


@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["plain", "kernel_wrappers"])
def test_decode_steps_match(run32, use_kernel):
    """4 decode steps fed the reference's greedy tokens (or llava's next
    embeddings), each step's logits against the reference's: `decode_step`
    (on the CPU its decode kernels' wrappers run their plain versions), and
    the same step through each layer's plain attention. The last caches
    too."""
    arch, cfg, tree, ported, out = run32
    m = Model(cfg)
    with torch.no_grad():
        inp = _port_inputs(out, T, m, ported)
        _, cache = m.prefill(ported, inp.get("tokens"),
                             embeds=inp.get("embeds"), max_seq=MAX_SEQ,
                             enc_out=inp.get("enc_out"))
        for i in range(STEPS):
            fed = out["fed"][i]
            tok = to_tensor(fed) if fed.ndim == 2 else \
                torch.as_tensor(fed).long()
            step = m.decode_step if use_kernel else \
                (lambda *a: _plain_decode_step(m, *a))
            ld, cache = step(ported, tok, cache)
            np.testing.assert_allclose(_t(ld), out["steps"][i], rtol=1e-4,
                                       atol=1e-4)
    assert int(cache["len"]) == T + STEPS
    for mine, ref in zip(cache["layers"], unstack_layers(out["last_cache"])):
        for name in ref:
            np.testing.assert_allclose(_t(mine[name]), _np(ref[name]),
                                       rtol=1e-4, atol=1e-4)


def test_init_cache_decodes_like_the_reference(run32):
    """An empty cache from `init_cache`, then one decode step from nothing
    cached, against the reference's `init_cache` + `decode_step`."""
    arch, cfg, tree, ported, out = run32
    tok = out["fed"][0]
    m = Model(cfg)
    cache = m.init_cache(B, MAX_SEQ, device="cpu", src_len=out["src_len"])
    assert int(cache["len"]) == 0
    with torch.no_grad():
        got, c2 = m.decode_step(ported, to_tensor(tok) if tok.ndim == 2 else
                                torch.as_tensor(tok).long(), cache)
    np.testing.assert_allclose(_t(got), out["from_empty"], rtol=1e-4,
                               atol=1e-4)
    assert int(c2["len"]) == 1 and int(cache["len"]) == 0


# ---------------------------------------------------------------------------
# the reference's own model contracts (tests/test_models.py), on the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", [a for a in ARCH_IDS])
def test_prefill_and_decode_match_forward(arch):
    """The port alone: prefill's last logits against forward's, and one
    decode step against forward on the grown sequence (the reference's
    rules: 2e-2; MLA the greedy token and 8e-2 / 2e-1)."""
    cfg = get_smoke_config(arch)
    m = Model(cfg)
    params = m.init(torch.Generator().manual_seed(1), device="cpu")
    g = torch.Generator().manual_seed(2)
    enc = {}
    if cfg.is_encoder_decoder:     # the reference test's 24 frames
        frames = torch.randn((B, SRC, cfg.d_model), generator=g).to(m.dtype)
        with torch.no_grad():
            enc = {"enc_out": m.encode(params, frames)}
    if cfg.uses_input_embeds:
        x = (torch.randn((B, T + 1, cfg.d_model), generator=g) * 0.02
             ).to(m.dtype)
        seq = {"embeds": x}
        first = {"embeds": x[:, :T]}
    else:
        x = torch.randint(0, cfg.vocab_size, (B, T), generator=g)
        first = {"tokens": x}
    with torch.no_grad():
        h = m.forward(params, first.get("tokens"), embeds=first.get("embeds"),
                      **enc)
        ref_last = m.logits(params, h[:, -1])
        lp, cache = m.prefill(params, first.get("tokens"),
                              embeds=first.get("embeds"), max_seq=T + 4,
                              **enc)
        np.testing.assert_allclose(lp.numpy(), ref_last.numpy(), rtol=2e-2,
                                   atol=2e-2)
        if cfg.uses_input_embeds:
            nxt = x[:, T]
            h2 = m.forward(params, embeds=seq["embeds"])
        else:
            nxt = lp.argmax(-1)
            h2 = m.forward(params, torch.cat([x, nxt[:, None]], 1), **enc)
        ld, _ = m.decode_step(params, nxt, cache)
        ref2 = m.logits(params, h2[:, -1])
    if cfg.attention == "mla":
        assert torch.equal(ld.argmax(-1), ref2.argmax(-1))
        np.testing.assert_allclose(ld.numpy(), ref2.numpy(), rtol=8e-2,
                                   atol=2e-1)
    else:
        np.testing.assert_allclose(ld.numpy(), ref2.numpy(), rtol=2e-2,
                                   atol=2e-2)


@pytest.mark.parametrize("arch,target,tol", [
    ("qwen3-moe-235b-a22b", 235e9, 0.15), ("olmoe-1b-7b", 6.9e9, 0.2),
    ("yi-9b", 8.8e9, 0.15), ("gemma2-9b", 9.2e9, 0.25),
    ("command-r-plus-104b", 104e9, 0.15), ("minicpm3-4b", 4.0e9, 0.3),
    ("recurrentgemma-2b", 2.7e9, 0.3), ("whisper-large-v3", 1.5e9, 0.4)])
def test_full_configs_have_expected_params(arch, target, tol):
    n = get_config(arch).param_count()
    assert abs(n - target) / target < tol, (arch, n, target)


def test_moe_active_params_much_smaller():
    cfg = get_config("qwen3-moe-235b-a22b")
    assert cfg.active_param_count() < 0.15 * cfg.param_count()


@pytest.mark.parametrize("arch", DENSE)
def test_serving_engines_stay_moe_only(arch):
    from repro_torch.runtime.engine import Engine, SlotBufferEngine
    cfg = get_smoke_config(arch)
    with pytest.raises(ValueError, match="MoE models only"):
        Engine(cfg, device="cpu")
    with pytest.raises(ValueError, match="MoE models only"):
        SlotBufferEngine(cfg, {}, Model(cfg), 4, device="cpu")
