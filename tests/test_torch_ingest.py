"""checkpoint.ingest in the port: safetensors -> expert shards (CPU).

- The reference's cases (`tests/test_ingest.py`) on the port: name
  parsing, a bitwise round trip through two files with mixed dtypes,
  ``transpose=False``, a missing projection, no expert tensors.
- The port and the reference ingest the same safetensors files (written
  with `safetensors.numpy`, which only the tests use) into byte-identical
  shard directories: f32 / f16 and bf16 checkpoints.
- The port's own header reader (it does not import `safetensors`):
  every tensor reads back bitwise, and a truncated header, a tensor past
  the end, overlapping offsets and a size that disagrees with the shape
  are rejected.
"""
import json
import os
import re
import struct

import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import ingest as ref_ingest
from repro_torch.checkpoint.ingest import (DEFAULT_PATTERN, PROJ_SLOT,
                                           SafetensorsFile,
                                           ingest_safetensors,
                                           parse_expert_key)
from repro_torch.core.expert_tiers import ExpertShardReader
from test_torch_expert_tiers import _bits

st = pytest.importorskip("safetensors.numpy")


# ---------------------------------------------------------------- parser

def test_parse_qwen_style_names():
    assert parse_expert_key(
        "model.layers.3.mlp.experts.7.gate_proj.weight") == (3, 7, 0)
    assert parse_expert_key(
        "model.layers.3.mlp.experts.7.up_proj.weight") == (3, 7, 1)
    assert parse_expert_key(
        "model.layers.12.mlp.experts.0.down_proj.weight") == (12, 0, 2)


def test_parse_mixtral_style_names():
    assert parse_expert_key(
        "model.layers.0.block_sparse_moe.experts.5.w1.weight") == (0, 5, 0)
    assert parse_expert_key(
        "model.layers.0.block_sparse_moe.experts.5.w3.weight") == (0, 5, 1)
    assert parse_expert_key(
        "model.layers.0.block_sparse_moe.experts.5.w2.weight") == (0, 5, 2)


def test_parse_rejects_non_expert_tensors():
    for name in ("model.layers.3.mlp.experts.7.gate_proj.bias",
                 "model.layers.3.self_attn.q_proj.weight",
                 "model.layers.3.mlp.gate.weight",
                 "model.embed_tokens.weight"):
        assert parse_expert_key(name) is None


def test_parse_custom_pattern():
    pat = re.compile(r"blk\.(?P<layer>\d+)\.exp\.(?P<expert>\d+)\."
                     r"(?P<proj>w1|w2|w3)$")
    assert parse_expert_key("blk.2.exp.9.w3", pat) == (2, 9, 1)
    assert parse_expert_key("blk.2.exp.9.w3") is None


def test_pattern_and_slots_equal_the_reference():
    assert DEFAULT_PATTERN.pattern == ref_ingest.DEFAULT_PATTERN.pattern
    assert PROJ_SLOT == ref_ingest.PROJ_SLOT


# ------------------------------------------------------------ round trip

def _hf_checkpoint(rng, layers, E, d, f, dtypes=(np.float32, np.float16,
                                                 np.float32)):
    """Synthetic HF-style tensor dict: gate/up stored (f, d), down (d, f)."""
    tensors = {}
    for li in layers:
        for e in range(E):
            base = f"model.layers.{li}.mlp.experts.{e}"
            for proj, shape, dt in zip(("gate_proj", "up_proj", "down_proj"),
                                       ((f, d), (f, d), (d, f)), dtypes):
                tensors[f"{base}.{proj}.weight"] = rng.standard_normal(
                    shape).astype(np.float32).astype(dt)
    tensors["model.embed_tokens.weight"] = np.ones((4, d), np.float32)
    return tensors


def _two_files(tmp_path, tensors):
    names = sorted(tensors)
    half = len(names) // 2
    p0, p1 = str(tmp_path / "a.safetensors"), str(tmp_path / "b.safetensors")
    st.save_file({k: tensors[k] for k in names[:half]}, p0)
    st.save_file({k: tensors[k] for k in names[half:]}, p1)
    return [p0, p1]


def test_safetensors_round_trip_bitwise(tmp_path):
    rng = np.random.default_rng(0)
    ckpt_layers, E, d, f = [1, 5], 3, 4, 6
    tensors = _hf_checkpoint(rng, ckpt_layers, E, d, f)
    out = ingest_safetensors(_two_files(tmp_path, tensors),
                             str(tmp_path / "shards"))
    r = ExpertShardReader(out)
    assert r.layers() == list(range(len(ckpt_layers)))
    assert all(r.num_experts(li) == E for li in r.layers())
    assert r.has_checksums()
    for dense, li in enumerate(ckpt_layers):
        for e in range(E):
            wg, wu, wd = r.read_expert(dense, e)
            base = f"model.layers.{li}.mlp.experts.{e}"
            np.testing.assert_array_equal(
                wg.numpy(), tensors[f"{base}.gate_proj.weight"].T)
            np.testing.assert_array_equal(
                wu.numpy(), tensors[f"{base}.up_proj.weight"].T)
            np.testing.assert_array_equal(
                wd.numpy(), tensors[f"{base}.down_proj.weight"].T)
    assert wu.dtype == torch.float16


def test_no_transpose_keeps_raw_layout(tmp_path):
    rng = np.random.default_rng(1)
    tensors = _hf_checkpoint(rng, [0], 2, 3, 5)
    p = str(tmp_path / "c.safetensors")
    st.save_file(tensors, p)
    out = ingest_safetensors(p, str(tmp_path / "shards"), transpose=False)
    wg, _, _ = ExpertShardReader(out).read_expert(0, 1)
    np.testing.assert_array_equal(
        wg.numpy(), tensors["model.layers.0.mlp.experts.1.gate_proj.weight"])


def test_missing_projection_rejected(tmp_path):
    rng = np.random.default_rng(2)
    tensors = _hf_checkpoint(rng, [0], 2, 3, 5)
    del tensors["model.layers.0.mlp.experts.1.up_proj.weight"]
    p = str(tmp_path / "d.safetensors")
    st.save_file(tensors, p)
    with pytest.raises(ValueError, match="missing its w_up"):
        ingest_safetensors(p, str(tmp_path / "shards"))


def test_no_expert_tensors_rejected(tmp_path):
    p = str(tmp_path / "e.safetensors")
    st.save_file({"model.embed_tokens.weight": np.ones((2, 2), np.float32)},
                 p)
    with pytest.raises(ValueError, match="no expert tensors"):
        ingest_safetensors(p, str(tmp_path / "shards"))


@pytest.mark.parametrize("kind", ["f32_f16", "bf16"])
def test_port_and_reference_ingest_are_byte_identical(tmp_path, kind):
    rng = np.random.default_rng(3)
    dtypes = ((np.float32, np.float16, np.float32) if kind == "f32_f16"
              else (ml_dtypes.bfloat16,) * 3)
    tensors = _hf_checkpoint(rng, [2, 0, 7], 4, 8, 12, dtypes)
    paths = _two_files(tmp_path, tensors)
    a = ref_ingest.ingest_safetensors(paths, str(tmp_path / "ref"))
    b = ingest_safetensors(paths, str(tmp_path / "port"))
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    for name in os.listdir(a):
        with open(os.path.join(a, name), "rb") as fa, \
                open(os.path.join(b, name), "rb") as fb:
            assert fa.read() == fb.read(), name


# --------------------------------------------------------- header reader

def test_header_reader_reads_every_tensor_bitwise(tmp_path):
    rng = np.random.default_rng(4)
    tensors = {"a": rng.standard_normal((3, 5)).astype(np.float32),
               "b": rng.standard_normal((7,)).astype(np.float16),
               "c": rng.standard_normal((2, 2, 3)).astype(ml_dtypes.bfloat16),
               "d": rng.standard_normal((4, 4)).astype(
                   ml_dtypes.float8_e4m3fn)}
    p = str(tmp_path / "f.safetensors")
    st.save_file(tensors, p, metadata={"format": "np"})
    f = SafetensorsFile(p)
    assert sorted(f.keys()) == sorted(tensors)
    for name, want in tensors.items():
        got = f.get_tensor(name)
        assert tuple(got.shape) == want.shape
        np.testing.assert_array_equal(_bits(got), _bits(want))


def _write_raw(path, header, data=b""):
    blob = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)) + blob + data)


@pytest.mark.parametrize("fault,match", [
    ("short_length", "too short"),
    ("truncated_header", "truncated"),
    ("past_end", "past the end"),
    ("overlap", "overlap"),
    ("bad_size", "need"),
    ("bad_dtype", "dtype"),
])
def test_header_reader_rejects_bad_files(tmp_path, fault, match):
    p = str(tmp_path / "bad.safetensors")
    a = {"dtype": "F32", "shape": [2, 2], "data_offsets": [0, 16]}
    b = {"dtype": "F32", "shape": [2], "data_offsets": [16, 24]}
    data = bytes(24)
    if fault == "short_length":
        with open(p, "wb") as f:
            f.write(b"\x01\x02")
    elif fault == "truncated_header":
        _write_raw(p, {"a": a, "b": b}, data)
        with open(p, "r+b") as f:
            f.truncate(20)
    elif fault == "past_end":
        _write_raw(p, {"a": a, "b": b}, data[:20])
    elif fault == "overlap":
        b = dict(b, data_offsets=[12, 20])
        _write_raw(p, {"a": a, "b": b}, data)
    elif fault == "bad_size":
        a = dict(a, shape=[3, 2])
        _write_raw(p, {"a": a, "b": b}, data)
    else:
        a = dict(a, dtype="I4")
        _write_raw(p, {"a": a, "b": b}, data)
    with pytest.raises(ValueError, match=match):
        SafetensorsFile(p)
