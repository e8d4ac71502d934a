"""The lookup of a configuration's model adapters (benchmark/models.py): a
role takes the module the configuration names, or the module of its own
name; a shipped adapter refuses an option its reference does not
implement, and a missing adapter fails before any step with the module's
name; the shipped adapters list the sites of chip_smoke.py's tables."""

import json
from pathlib import Path

import pytest

from benchmark import models
from benchmark.adapters import act3d, planner
from benchmark.drivers.keystep import ROLES
from test_bench_work import KEYPOSE_SHAPES, SHAPES, TRAIN_SHAPES
from tiny import run_tiny, tiny_config, tiny_root

ROOT = Path(__file__).resolve().parents[2]
CD = json.loads((ROOT / "benchmark/configs/chained_diffuser.json").read_text())
A3 = json.loads((ROOT / "benchmark/configs/act3d.json").read_text())


def test_a_role_takes_the_named_module_or_its_own():
    cfg = tiny_config()
    assert models.adapter(cfg, "planner") is planner and models.adapter(cfg, "act3d") is act3d
    cfg["adapters"] = {"planner": "act3d"}
    with pytest.raises(ValueError, match="planner: the reference implements"):
        models.adapter(cfg, "planner")  # the planner's section against Act3D's options
    assert models.adapter(cfg, "act3d") is act3d


@pytest.mark.parametrize("option,value", [("feat_scales_to_use", 3),
                                          ("rotation_parametrization", "quat"),
                                          ("backbone", "resnet")])
def test_planner_adapter_refuses_options_its_reference_lacks(option, value):
    cfg = tiny_config()
    cfg["planner"][option] = value
    with pytest.raises(ValueError, match=f"implements {option}="):
        models.adapter(cfg, "planner")


def _refuse_steps(monkeypatch):
    from act3d_tpu_torch.eval.actioner import Actioner
    from act3d_tpu_torch.train.engine import Trainer

    def step(*args, **kwargs):
        raise AssertionError("a step ran before the configuration was refused")

    monkeypatch.setattr(Trainer, "step", step)
    monkeypatch.setattr(Actioner, "predict", step)


REFUSED = [("tiny.train", "planner", {"adapters": {"planner": "no_such_adapter"}},
            ModuleNotFoundError, "no_such_adapter"),
           ("tiny.keystep", "planner", {"adapters": {"planner": "no_such_adapter"}},
            ModuleNotFoundError, "no_such_adapter"),
           ("tiny.keystep", "act3d", {"adapters": {"act3d": "no_such_adapter"}},
            ModuleNotFoundError, "no_such_adapter"),
           ("tiny.train", "planner", {"planner": {"feat_scales_to_use": 3}},
            ValueError, "feat_scales_to_use")]


@pytest.mark.parametrize("workload,role,change,error,named", REFUSED,
                         ids=[f"{w}-{r}-{n}" for w, r, _, _, n in REFUSED])
def test_a_refused_configuration_fails_before_any_step(tmp_path, monkeypatch, workload, role,
                                                       change, error, named):
    root = tiny_root(tmp_path)
    path = root / "benchmark/configs/tiny.json"
    cfg = json.loads(path.read_text())
    for key, value in change.items():
        cfg[key] = {**cfg.get(key, {}), **value}
    path.write_text(json.dumps(cfg))
    _refuse_steps(monkeypatch)
    with pytest.raises(error, match=named):
        run_tiny(root, workload)


def test_shipped_adapters_list_the_chip_smoke_sites():
    keystep = [s for role in ROLES for s in models.adapter(CD, role).sites(CD, 1, training=False)]
    assert [(s.name, s.l, s.s, s.e, s.h, s.masked, s.count) for s in keystep] == SHAPES
    train = models.adapter(CD, "planner").sites(CD, 22, training=True)
    assert [(s.l, s.s, s.count) for s in train] == TRAIN_SHAPES and all(s.b == 22 for s in train)
    keypose = models.adapter(A3, "act3d").sites(A3, 16, training=True)
    assert [(s.l, s.s, s.count) for s in keypose] == KEYPOSE_SHAPES
    assert models.adapter(CD, "planner").noise_width(CD) == 9  # 3 position + 6D
