"""The port's checkpoints (round trip, retention, the reference's format
both ways, bitwise), `TrainRunner` restarting from a checkpoint, and the
train CLI (`launch/train.py`) on the CPU."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpointer as jax_ckpt
from repro_torch.checkpoint.checkpointer import (Checkpointer, latest_step,
                                                 load_checkpoint,
                                                 save_checkpoint)
from repro_torch.distributed.fault_tolerance import TrainRunner
from repro_torch.launch import train
from repro_torch.tree import leaves_with_paths, tree_leaves, tree_map


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"embed": torch.randn(6, 4, generator=g).bfloat16(),
            "layers": [{"w": torch.randn(4, 3, generator=g),
                        "n": torch.randn(3, generator=g).bfloat16()},
                       {"w": torch.randn(4, 3, generator=g),
                        "n": torch.randn(3, generator=g).bfloat16()}],
            "step": torch.tensor(7, dtype=torch.long)}


def _bits(t):
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _same(a, b):
    la, lb = leaves_with_paths(a), leaves_with_paths(b)
    assert [k for k, _ in la] == [k for k, _ in lb]
    for (k, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(_bits(x), _bits(y)), k


def test_checkpoint_round_trip_is_bitwise(tmp_path):
    tree = _tree()
    save_checkpoint(str(tmp_path / "step_3"), tree, step=3)
    like = tree_map(torch.zeros_like, tree)
    back, step = load_checkpoint(str(tmp_path / "step_3"), like)
    assert step == 3
    _same(back, tree)
    with pytest.raises(ValueError, match="structure mismatch"):
        load_checkpoint(str(tmp_path / "step_3"), {"embed": tree["embed"]})


def test_checkpointer_every_keep_and_restore(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2, every=2)
    trees = {}
    for s in range(1, 8):
        trees[s] = _tree(s)
        assert ck.maybe_save(s, trees[s]) == (s % 2 == 0)
    ck.wait()
    kept = sorted(p.name for p in tmp_path.iterdir() if p.is_dir())
    assert kept == ["step_4", "step_6"]
    assert latest_step(str(tmp_path)) == 6
    back, step = ck.restore_latest(tree_map(torch.zeros_like, _tree()))
    assert step == 6
    _same(back, trees[6])
    assert Checkpointer(str(tmp_path / "none")).restore_latest(_tree()) == \
        (None, None)


def test_reference_writes_port_reads_bitwise(tmp_path):
    rng = np.random.default_rng(0)
    ref = {"embed": jnp.asarray(rng.standard_normal((6, 4)), jnp.bfloat16),
           "layers": [{"w": jnp.asarray(rng.standard_normal((4, 3)),
                                        jnp.float32),
                       "n": jnp.asarray(rng.standard_normal(3),
                                        jnp.bfloat16)}] * 2,
           "step": jnp.asarray(7, jnp.int32)}
    jax_ckpt.save_checkpoint(str(tmp_path / "ref"), ref, step=5)
    like = {"embed": torch.zeros(6, 4, dtype=torch.bfloat16),
            "layers": [{"w": torch.zeros(4, 3),
                        "n": torch.zeros(3, dtype=torch.bfloat16)}] * 2,
            "step": torch.zeros((), dtype=torch.int32)}
    back, step = load_checkpoint(str(tmp_path / "ref"), like)
    assert step == 5
    manifest = json.loads((tmp_path / "ref" / "manifest.json").read_text())
    want = jax.tree_util.tree_flatten_with_path(ref)[0]
    keys = ["/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path) for path, _ in want]
    assert [r["key"] for r in manifest["leaves"]] == keys
    assert [k for k, _ in leaves_with_paths(back)] == keys
    for (_, w), got in zip(want, tree_leaves(back)):
        w = np.asarray(w)
        if w.dtype.name == "bfloat16":
            assert got.dtype == torch.bfloat16
            assert np.array_equal(got.view(torch.int16).numpy(),
                                  w.view(np.int16))
        else:
            assert np.array_equal(got.numpy(), w)


def test_port_writes_reference_reads_bitwise(tmp_path):
    tree = _tree(9)
    save_checkpoint(str(tmp_path / "port"), tree, step=11)
    like = {"embed": jnp.zeros((6, 4), jnp.bfloat16),
            "layers": [{"w": jnp.zeros((4, 3), jnp.float32),
                        "n": jnp.zeros((3,), jnp.bfloat16)}] * 2,
            "step": jnp.zeros((), jnp.int64)}
    back, step = jax_ckpt.load_checkpoint(str(tmp_path / "port"), like)
    assert step == 11
    for got, (_, want) in zip(jax.tree.leaves(back),
                              leaves_with_paths(tree)):
        got = np.asarray(got)
        if want.dtype == torch.bfloat16:
            assert np.array_equal(got.view(np.int16),
                                  want.view(torch.int16).numpy())
        else:
            assert np.array_equal(got, want.numpy())


def _counter_step(fail_at=()):
    """A step that adds the batch to a tensor state; raises once at each
    step in `fail_at`."""
    failed = set()

    def step(state, batch):
        n = int(state["n"])
        if n + 1 in fail_at and n + 1 not in failed:
            failed.add(n + 1)
            raise RuntimeError("injected failure")
        return ({"x": state["x"] + batch, "n": state["n"] + 1},
                {"loss": float(state["x"].sum())})

    return step


def test_train_runner_restarts_from_a_checkpoint(tmp_path):
    batches = [torch.full((3,), float(i)) for i in range(100)]
    init = {"x": torch.zeros(3), "n": torch.tensor(0)}
    # a step that fails once is rerun from the last checkpoint
    r = TrainRunner(_counter_step(fail_at={5}),
                    Checkpointer(str(tmp_path / "a"), every=2), init)
    seen = []
    out = r.run(iter(batches), 6, metrics_cb=lambda s, m: seen.append(s))
    assert r.step == 6 and int(out["n"]) == 6
    assert seen == [1, 2, 3, 4, 5, 6]
    # a new runner resumes from the latest checkpoint
    ck = Checkpointer(str(tmp_path / "b"), every=3)
    TrainRunner(_counter_step(), ck, init).run(iter(batches), 6)
    r2 = TrainRunner(_counter_step(), ck, init)
    assert r2.restore_if_available(init)
    assert r2.step == 6 and int(r2.state["n"]) == 6
    assert torch.equal(r2.state["x"], torch.full((3,), 15.0))


def test_train_cli_smoke_loss_falls_and_resumes(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    res = train.main(["--arch", "olmoe-1b-7b", "--smoke", "--device", "cpu",
                      "--steps", "12", "--batch", "4", "--seq", "16",
                      "--lr", "3e-3", "--ckpt-dir", ck, "--ckpt-every", "6"])
    out = capsys.readouterr().out
    assert "step     1 loss" in out and "final loss:" in out
    assert len(res["losses"]) == 12 and all(np.isfinite(res["losses"]))
    assert np.mean(res["losses"][-3:]) < res["losses"][0]
    assert latest_step(ck) == 12
    res2 = train.main(["--arch", "olmoe-1b-7b", "--smoke", "--device", "cpu",
                       "--steps", "14", "--batch", "4", "--seq", "16",
                       "--lr", "3e-3", "--ckpt-dir", ck, "--ckpt-every", "6",
                       "--resume"])
    assert "resumed from step 12" in capsys.readouterr().out
    assert res2["start_step"] == 12 and len(res2["losses"]) == 2


def test_train_cli_compress_grads_on_a_dense_arch(tmp_path):
    res = train.main(["--arch", "yi-9b", "--smoke", "--device", "cpu",
                      "--steps", "3", "--batch", "2", "--seq", "8",
                      "--compress-grads", "--ckpt-dir", str(tmp_path)])
    assert len(res["losses"]) == 3 and all(np.isfinite(res["losses"]))
    assert res["state"][2] is not None


@pytest.mark.parametrize("mesh,ranks", [("16x16", 256), ("2x16x16", 512)])
def test_train_cli_pod_meshes_raise(mesh, ranks, tmp_path):
    """Without a process group of the mesh's size (torchrun), a pod mesh
    raises, naming the ranks it needs."""
    with pytest.raises(RuntimeError, match=f"{ranks} ranks"):
        train.main(["--smoke", "--device", "cpu", "--mesh", mesh,
                    "--ckpt-dir", str(tmp_path)])
    assert not torch.distributed.is_initialized()


def test_train_cli_host_mesh_losses_unchanged(tmp_path, monkeypatch):
    """`--mesh host` trains inside a one-rank mesh's context with the
    params distributed (FSDP): its losses are bitwise those of the same
    steps without a mesh (f32 smoke), and the CLI closes the group it
    opened."""
    import dataclasses

    from repro_torch.data.pipeline import token_batches
    from repro_torch.models.transformer import Model
    from repro_torch.training.optimizer import adamw_init, adamw_update
    from repro_torch.training.steps import make_loss_fn, value_and_grad
    smoke = train.get_smoke_config
    f32 = lambda a: dataclasses.replace(smoke(a),  # noqa: E731
                                        dtype="float32")
    monkeypatch.setattr(train, "get_smoke_config", f32)
    res = train.main(["--arch", "olmoe-1b-7b", "--smoke", "--device", "cpu",
                      "--steps", "3", "--batch", "2", "--seq", "16",
                      "--lr", "3e-3", "--ckpt-dir", str(tmp_path)])
    assert not torch.distributed.is_initialized()
    cfg = f32("olmoe-1b-7b")
    model = Model(cfg)
    params = model.init(torch.Generator("cpu").manual_seed(0), device="cpu")
    opt = adamw_init(params)
    vg = value_and_grad(make_loss_fn(model, remat=True, ce_chunk=512))
    want = []
    for (toks, labels), _ in zip(token_batches(cfg.vocab_size, 2, 16),
                                 range(3)):
        loss, grads = vg(params, {"tokens": torch.from_numpy(toks).long(),
                                  "labels": torch.from_numpy(labels).long()})
        params, opt = adamw_update(grads, opt, params, lr=3e-3)
        want.append(float(loss))
    assert res["losses"] == want


def test_train_cli_needs_cuda_unless_asked_for_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--smoke", "--steps", "1", "--ckpt-dir", str(tmp_path)])


def test_train_cli_refuses_an_encoder_decoder(tmp_path):
    """The CLI feeds token batches only, as the reference's does; whisper's
    loss takes frames too, so it raises a clear error instead."""
    with pytest.raises(NotImplementedError, match="encoder-decoder"):
        train.main(["--arch", "whisper-large-v3", "--smoke", "--device",
                    "cpu", "--steps", "1", "--ckpt-dir", str(tmp_path)])
