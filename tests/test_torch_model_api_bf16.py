"""The port's `Model` layers in bf16 against the reference's, on the
dense archs at smoke sizes (the attention-only ones, recurrentgemma,
xlstm and whisper, whose encoder layers are held the same way), layer by
layer: each layer is handed
the reference's input and cache, and each step's logits come from the
reference's last hidden state (the reference test's rules: 2e-2; MLA the
same greedy token and 8e-2 / 2e-1). Free-running, the two frameworks'
bf16 products round apart in the last bit and the drift passes 2e-2 on the
smoke logits (up to |50| on the tied models), each run as far from the f32
model as from the other; f32 is held free-running in
`test_torch_model_api.py`. gemma2's smoke window is 16 rows: the 16-token
prompt fills its ring and the 4 decode steps wrap it. The recurrent
mixers' states are caches like the others; whisper's decoder layers take
the reference's encoder output (24 frames) for their cross-attention.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as jax_smoke
from repro.models import transformer as jax_tf
from repro.runtime.engine import _layer_params
from repro_torch.bridge import params_from_reference, to_tensor
from repro_torch.configs import get_smoke_config
from repro_torch.models import Model
from repro_torch.models import transformer

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


def _encode_layers(jm, jcfg, params, frames):
    """The reference's encoder, layer by layer: [(input, output)] and its
    normed output."""
    enc = params["encoder"]
    pos = jnp.broadcast_to(jnp.arange(SRC)[None], (B, SRC))
    x = jnp.asarray(frames) + jax_tf.sinusoidal_pos(
        pos, jcfg.d_model).astype(jm.dtype)
    spec = jax_tf.LayerSpec("attn", 0, False, 0)
    fwd = jax.jit(lambda p, x: jax_tf.layer_forward(p, jcfg, spec, x, pos,
                                                    causal=False))
    layers = []
    for i in range(jcfg.encoder_layers):
        y = fwd(jax.tree.map(lambda a: a[i], enc["layers"]), x)
        layers.append((np.asarray(x), np.asarray(y)))
        x = y
    out = jax_tf.rms_norm(x, enc["final_norm"], jcfg.norm_eps)
    return layers, out, pos


@pytest.fixture(scope="module", params=DENSE)
def run16(request):
    """The reference in bf16, layer by layer (the computation its Model
    scans), recording every layer's input, output and cache for the
    prefill and each of 4 decode steps, so the port can be handed the
    reference's inputs and caches at every layer: the two frameworks'
    bf16 products round apart in the last bit, and free-running that
    drift passes 2e-2 on the smoke logits (up to |50| on the tied models),
    as far from f32 as each framework's own bf16 run is."""
    arch = request.param
    jcfg, tcfg = _cfgs(arch, "bfloat16")
    jm = jax_tf.Model(jcfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(7))
    tree = jax.tree.map(np.asarray, params)
    toks, embeds, frames = _ref_inputs(jcfg, jm)
    enc, enc_layers = {}, []
    if frames is not None:
        enc_layers, enc_out, enc_pos = _encode_layers(jm, jcfg, params,
                                                      frames)
        enc = {"enc_out": enc_out, "enc_pos": enc_pos}
    lps = [_layer_params(jm, params, i) for i in range(jcfg.num_layers)]
    specs = [transformer.all_specs(tcfg)[i] for i in range(jcfg.num_layers)]
    jspecs = [jax_tf.LayerSpec(*s) for s in specs]
    x = jnp.asarray(embeds[:, :T]) if embeds is not None else \
        jm.embed(params, jnp.asarray(toks))
    pos = jnp.broadcast_to(jnp.arange(T)[None], (B, T))
    prefill = {sp: jax.jit(lambda p, x, sp=sp: jax_tf.layer_prefill(
        p, jcfg, sp, x, pos, MAX_SEQ, **enc)) for sp in set(jspecs)}
    decode = {sp: jax.jit(lambda p, x, c, n, sp=sp: jax_tf.layer_decode(
        p, jcfg, sp, x, c, n)) for sp in set(jspecs)}
    pre, caches = [], []
    for p, sp in zip(lps, jspecs):
        y, c = prefill[sp](p, x)
        pre.append((np.asarray(x), np.asarray(y),
                    jax.tree.map(np.asarray, c)))
        caches.append(c)
        x = y
    logits = jax.jit(jm.logits)
    lp = logits(params, x[:, -1])
    dec, nxt = [], jnp.argmax(lp, -1).astype(jnp.int32)
    for i in range(STEPS):
        x = jnp.asarray(embeds[:, T + i])[:, None] if embeds is not None \
            else jm.embed(params, nxt[:, None],
                          positions=jnp.full((B, 1), T + i))
        layers = []
        for li, (p, sp) in enumerate(zip(lps, jspecs)):
            y, c = decode[sp](p, x, caches[li],
                              jnp.asarray(T + i, jnp.int32))
            layers.append((np.asarray(x), jax.tree.map(np.asarray,
                                                       caches[li]),
                           np.asarray(y), jax.tree.map(np.asarray, c)))
            caches[li], x = c, y
        ld = logits(params, x[:, 0])
        dec.append((layers, np.asarray(x[:, 0]), _np(ld)))
        nxt = jnp.argmax(ld, -1).astype(jnp.int32)
    out = {"prefill_layers": pre, "prefill_x": np.asarray(x), "decode": dec,
           "last_h": np.asarray(pre[-1][1][:, -1]), "prefill": _np(lp),
           "toks": toks, "embeds": embeds, "frames": frames,
           "enc_layers": enc_layers,
           "enc": {k: np.asarray(v) for k, v in enc.items()}}
    return arch, tcfg, specs, params_from_reference(tree), out


def _port_inputs(out, n):
    if out["embeds"] is not None:
        return {"embeds": to_tensor(out["embeds"][:, :n])}
    inp = {"tokens": torch.as_tensor(out["toks"][:, :n]).long()}
    if out["enc"]:
        inp["enc_out"] = to_tensor(out["enc"]["enc_out"])
    return inp


def _enc(out):
    """The reference's encoder output and positions, for the port's
    decoder layers."""
    return {k: to_tensor(v) for k, v in out["enc"].items()}


def _cache_t(c):
    return {k: to_tensor(v) for k, v in c.items()}


def _close16(got, want, residual=False):
    """2e-2. On a layer's output, the residual sum, the absolute part is
    scaled by the tensor's RMS where that passes 1: gemma2's residual
    stream runs at sqrt(d) times the others' (its embeddings are scaled),
    so one bf16 rounding of a large addend is an absolute difference of up
    to 2^-8 of it where the sum cancels. Caches and logits are held at 2e-2
    as they are."""
    want = _np(want)
    scale = max(1.0, float(np.sqrt(np.mean(want * want)))) if residual \
        else 1.0
    np.testing.assert_allclose(_t(got), want, rtol=2e-2, atol=2e-2 * scale)


def test_bf16_prefill_layer_by_layer(run16):
    """Each layer's `layer_prefill` on the reference's input: output and
    cache (gemma2's ring filled by the 16-token prompt) within 2e-2; the
    last logits from the reference's last hidden state, and the port's
    `Model.prefill` taking the same tokens to a cache of the same shapes."""
    arch, cfg, specs, ported, out = run16
    m = Model(cfg)
    pos = torch.arange(T)[None].expand(B, T)
    with torch.no_grad():
        for (x, y, c), p, sp in zip(out["prefill_layers"], ported["layers"],
                                    specs):
            yt, ct = transformer.layer_prefill(p, cfg, sp, to_tensor(x), pos,
                                               MAX_SEQ, **_enc(out))
            _close16(yt, y, residual=True)
            assert set(ct) == set(c)
            for name in c:
                _close16(ct[name], c[name])
        lp = m.logits(ported, to_tensor(out["last_h"]))
        inp = _port_inputs(out, T)
        _, cache = m.prefill(ported, inp.get("tokens"),
                             embeds=inp.get("embeds"), max_seq=MAX_SEQ,
                             enc_out=inp.get("enc_out"))
    _close16(lp, out["prefill"])
    for mine, (_, _, c) in zip(cache["layers"], out["prefill_layers"]):
        assert {k: tuple(v.shape) for k, v in mine.items()} == \
            {k: v.shape for k, v in c.items()}


@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["plain", "kernel_wrappers"])
def test_bf16_decode_layer_by_layer(run16, use_kernel):
    """4 decode steps, each layer's `layer_decode` on the reference's input
    and cache (gemma2's local ring wraps): output and new cache within
    2e-2; each step's logits from the reference's last hidden state within
    2e-2 (MLA: the same greedy token and 8e-2 / 2e-1)."""
    arch, cfg, specs, ported, out = run16
    m = Model(cfg)
    with torch.no_grad():
        for i, (layers, h, ld) in enumerate(out["decode"]):
            clen = torch.tensor(T + i)
            for (x, c, y, c2), p, sp in zip(layers, ported["layers"],
                                            specs):
                yt, ct = transformer.layer_decode(
                    p, cfg, sp, to_tensor(x), _cache_t(c), clen,
                    use_kernel=use_kernel)
                _close16(yt, y, residual=True)
                for name in c2:
                    _close16(ct[name], c2[name])
            got = _t(m.logits(ported, to_tensor(h)))
            if cfg.attention == "mla":
                assert np.array_equal(got.argmax(-1), ld.argmax(-1))
                np.testing.assert_allclose(got, ld, rtol=8e-2, atol=2e-1)
            else:
                np.testing.assert_allclose(got, ld, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("run16", ["whisper-large-v3"], indirect=True)
def test_bf16_encoder_layer_by_layer(run16):
    """whisper's encoder: each layer (bidirectional, no cross-attention)
    on the reference's input within 2e-2, and `Model.encode` of the same
    frames against the reference's output."""
    arch, cfg, specs, ported, out = run16
    pos = torch.arange(SRC)[None].expand(B, SRC)
    with torch.no_grad():
        for (x, y), p in zip(out["enc_layers"], ported["encoder"]["layers"]):
            yt = transformer.layer_forward(p, cfg, transformer.ENCODER_SPEC,
                                           to_tensor(x), pos, causal=False)
            _close16(yt, y, residual=True)
        enc_out = Model(cfg).encode(ported, to_tensor(out["frames"]))
    _close16(enc_out, out["enc"]["enc_out"])
