"""The frozen reference against the port at smoke size on the CPU, and the
harness end to end at smoke size."""
import copy

import pytest
import torch

import run
import smoke
from pbcore import model as pbmodel
from reference import model as ref_model
from reference.weights import make_all


@pytest.mark.parametrize("name", ["olmoe-1b-7b.slots16",
                                  "deepseek-v2-lite.slots16"])
def test_published_configs_run_as_stated(name):
    conf = run.load_json(run.HERE / "configs" / f"{name}.json")
    cfg = pbmodel.port_config(conf)
    assert cfg.moe.num_experts == 64
    pbmodel.check_layout(conf, cfg)          # raises where they differ


def test_a_key_the_program_would_not_run_is_refused():
    conf = dict(run.load_json(
        run.HERE / "configs" / "deepseek-v2-lite.slots16.json"),
        norm_topk_prob=True)
    with pytest.raises(ValueError):
        pbmodel.port_config(conf)


@pytest.mark.parametrize("conf", [smoke.OLMOE, smoke.DEEPSEEK],
                         ids=["olmoe", "deepseek"])
def test_reference_is_the_ports_model_in_f32(conf):
    """The port's plain `Model.forward` in f32 (drop-free capacity) on the
    reference's weights, against the reference's logits."""
    conf = copy.deepcopy(conf)
    conf["as_run"]["overrides"]["moe.capacity_factor"] = 4.0
    cfg = pbmodel.port_config(conf)
    seed = 2 ** 35 + 1
    layout = ref_model.layout(ref_model.arch_of(conf))
    params = pbmodel.make_params(seed, layout, "cpu")
    f32 = {"embed": params["embed"].float(),
           "final_norm": params["final_norm"].float(),
           "lm_head": params["lm_head"].float(),
           "layers": [{k: (v.float() if torch.is_tensor(v) else
                           {k2: (v2.float() if torch.is_tensor(v2) else
                                 {k3: v3.float() for k3, v3 in v2.items()})
                            for k2, v2 in v.items()})
                       for k, v in lp.items()} for lp in params["layers"]]}
    import dataclasses
    from repro_torch.models.transformer import Model
    model = Model(dataclasses.replace(cfg, dtype="float32"))
    tokens = torch.randint(0, 512, (1, 24), generator=torch.Generator()
                           .manual_seed(3))
    h = model.forward(f32, tokens)
    port = model.logits(f32, h)[0]
    ref = ref_model.logits_at(conf, seed, [tokens[0]],
                              [torch.arange(24)], "cpu")[0]
    assert torch.allclose(port, ref, atol=1e-4, rtol=1e-4), \
        (port - ref).abs().max()


def test_weights_are_a_function_of_the_seed():
    layout = ref_model.layout(ref_model.arch_of(smoke.DEEPSEEK))
    a = make_all(5, layout, "cpu")
    b = make_all(5, layout, "cpu")
    c = make_all(6, layout, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["layers.1.moe.w_gate"],
                           c["layers.1.moe.w_gate"])
    assert a["layers.1.moe.router"].dtype == torch.float32
    assert a["layers.1.moe.w_gate"].dtype == torch.bfloat16


@pytest.mark.parametrize("model,mix", [("olmoe", None), ("deepseek", None),
                                       ("olmoe", "longprompt")])
def test_a_smoke_run_is_correct(model, mix):
    """The cell with each model at smoke size, and olmoe under a small
    long-prompt mix, whose window opens at the first decode step."""
    c = smoke.cell(model, mix)
    result, served = smoke.run_smoke(c=c)
    assert result["correct"], result["checks"]
    assert result["checks"]["tokens_compared"]["value"] >= 10
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "checks"]
    assert {"setup_s", "itl_p95_ms"} <= set(result["metrics"])
    assert served and result["attempted"] == len(served)
