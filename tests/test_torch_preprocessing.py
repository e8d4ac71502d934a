"""The port's preprocessing tools and registry against the JAX package's.

Same inputs on both sides, on the CPU: the registry's suites and loaders
over the vendored assets; ``compute_workspace_bounds`` and ``validate``
over one episode tree (``act3d_tpu.data.fixtures`` plus ``.npy`` / ``.pkl``
and schema-breaking episodes); ``pack_demo`` through a duck-typed env and
demo (the ``.dat`` bytes); ``preprocess_instructions`` with an offline CLIP
pair (needs ``transformers``); ``dataset_generator`` trees byte for byte,
with the same retries and clean-up.
"""

import json
import pickle

import numpy as np
import pytest

from act3d_tpu.data import episode as jepisode
from act3d_tpu.data import fixtures as jfixtures
from act3d_tpu.preprocessing import compute_workspace_bounds as jbounds
from act3d_tpu.preprocessing import data_gen as jdata_gen
from act3d_tpu.preprocessing import dataset_generator as jgen
from act3d_tpu.preprocessing import preprocess_instructions as jinstr
from act3d_tpu.preprocessing import validate as jvalidate
from act3d_tpu.utils import registry as jregistry
from act3d_tpu_torch.preprocessing import compute_workspace_bounds as pbounds
from act3d_tpu_torch.preprocessing import data_gen as pdata_gen
from act3d_tpu_torch.preprocessing import dataset_generator as pgen
from act3d_tpu_torch.preprocessing import preprocess_instructions as pinstr
from act3d_tpu_torch.preprocessing import validate as pvalidate
from act3d_tpu_torch.utils import registry as pregistry

from tests.test_dataset_generator import CAMS, FlakyEnv, make_demo

SUITES = ("PERACT_18_TASKS", "HIVEFORMER_74_TASKS", "AUTOLAMBDA_10_TASKS", "ALL_TASKS",
          "TASK_TO_ID")


@pytest.mark.parametrize("name", SUITES)
def test_registry_suites_equal_jax(name):
    assert getattr(pregistry, name) == getattr(jregistry, name)


def test_registry_loaders_equal_jax_over_the_vendored_assets():
    csvs = sorted(p.name for p in (pregistry.ASSETS_DIR / "tasks").glob("*.csv"))
    assert len(csvs) >= 10
    for name in csvs:  # bare names resolve to the vendored assets
        assert pregistry.load_task_csv(name) == jregistry.load_task_csv(name), name
    episodes = pregistry.load_episodes()
    assert episodes == jregistry.load_episodes()
    known = set(episodes["max_episode_length"])
    for suite in (jregistry.PERACT_18_TASKS, jregistry.HIVEFORMER_74_TASKS, ("pick_and_lift",)):
        tasks = tuple(t for t in suite if t in known)
        assert tasks
        assert (pregistry.get_max_episode_length(episodes, tasks, (0,))
                == jregistry.get_max_episode_length(episodes, tasks, (0,)))


def _object_array(items):
    out = np.empty(len(items), dtype=object)
    for i, x in enumerate(items):
        out[i] = x
    return out


@pytest.fixture
def episode_tree(tmp_path):
    """pick_and_lift+0: two JAX fixture episodes (.dat), one .npy and one
    .pkl; pick_and_lift+1: an episode whose trajectories lack the eighth
    column and a 5-slot one; close_door has none."""
    root = jfixtures.make_dataset_tree(tmp_path / "data", episodes_per_variation=2,
                                       n_frames=3, n_cam=2, image_size=16, seed=3)
    task = root / "pick_and_lift+0"
    np.save(task / "ep2.npy", _object_array(jfixtures.make_episode(image_size=16, seed=9)),
            allow_pickle=True)
    with open(task / "ep3.pkl", "wb") as f:
        pickle.dump(jfixtures.make_episode(image_size=16, seed=10), f)
    jepisode.save_episode(root / "pick_and_lift+1" / "ep1.dat",
                          jfixtures.make_episode(image_size=16, seed=11)[:5])
    bad = jfixtures.make_episode(image_size=16, seed=12)
    bad[5] = [t[:, :7] for t in bad[5]]
    jepisode.save_episode(root / "pick_and_lift+1" / "ep0.dat", bad)
    return root


def test_workspace_bounds_json_equals_jax(episode_tree, tmp_path):
    argv = ["--dataset", str(episode_tree), "--tasks", "pick_and_lift", "close_door",
            "--variations", "0"]
    jbounds.main(argv + ["--out_file", str(tmp_path / "jax.json")])
    pbounds.main(argv + ["--out_file", str(tmp_path / "port.json")])
    got = (tmp_path / "port.json").read_bytes()
    assert got == (tmp_path / "jax.json").read_bytes()
    assert list(json.loads(got)) == ["pick_and_lift"]
    capped = pbounds.compute_bounds(episode_tree, ["pick_and_lift"], (0,),
                                    max_episodes_per_task=1)
    assert capped == jbounds.compute_bounds(episode_tree, ["pick_and_lift"], (0,),
                                            max_episodes_per_task=1)
    for mod in (jbounds, pbounds):  # a 5-slot episode has no trajectories (kept)
        with pytest.raises(IndexError):
            mod.compute_bounds(episode_tree, ["pick_and_lift"], (1,))


@pytest.mark.parametrize("deep", [False, True])
def test_validate_report_equals_jax(episode_tree, capsys, deep):
    argv = ["--dataset", str(episode_tree), "--tasks", "pick_and_lift", "close_door",
            "--variations", "0", "1"] + (["--deep"] if deep else [])
    jvalidate.main(argv)
    want = capsys.readouterr().out
    pvalidate.main(argv)
    got = capsys.readouterr().out
    assert got == want
    # JAX's quirks, kept: .pkl episodes are not counted, --deep reads .dat only
    assert "pick_and_lift+0: 3" in got and "close_door+0: MISSING" in got
    if deep:
        assert "schema check: 2 bad episodes" in got
    for path in sorted(episode_tree.rglob("ep*.*")):
        assert pvalidate.check_episode_schema(path) == jvalidate.check_episode_schema(path)


class DemoObs:
    """An RLBench Observation's fields that data_gen reads."""

    def __init__(self, rng, gripper_open, moving):
        self.gripper_open = gripper_open
        self.joint_velocities = rng.normal(0, 1 if moving else 1e-3, 7)
        q = rng.normal(size=4)
        self.gripper_pose = np.concatenate([rng.uniform(-0.3, 0.3, 3), q / np.linalg.norm(q)])
        self.misc = {}
        for i, cam in enumerate(CAMS):
            ext = np.eye(4)
            ext[:3, 3] = (0.1 * i, 0.0, -2.0)
            self.misc[f"{cam}_camera_extrinsics"] = ext
            self.misc[f"{cam}_camera_intrinsics"] = np.array([[20.0, 0, 8], [0, 20.0, 8],
                                                               [0, 0, 1]])
        self.rgb = {cam: rng.integers(0, 256, (16, 16, 3)).astype(np.uint8) for cam in CAMS}
        self.pc = {cam: rng.uniform(-1, 1, (16, 16, 3)).astype(np.float32) for cam in CAMS}


class DemoList(list):
    @property
    def _observations(self):
        return self


class DemoEnv:
    def get_obs_action(self, obs):
        state = {"rgb": [obs.rgb[c] for c in CAMS], "pc": [obs.pc[c] for c in CAMS]}
        action = np.concatenate([obs.gripper_pose, [float(obs.gripper_open)]])
        return state, action


def test_pack_demo_writes_the_bytes_jax_writes(tmp_path):
    rng = np.random.default_rng(4)
    opens = [1, 1, 1, 0, 0, 0, 0, 1, 1, 1]
    demo = DemoList(DemoObs(rng, g, moving=i not in (5,)) for i, g in enumerate(opens))
    want = jdata_gen.pack_demo(DemoEnv(), demo, CAMS)
    got = pdata_gen.pack_demo(DemoEnv(), demo, CAMS)
    assert len(got) == 7 and len(got[0]) >= 2
    jepisode.save_episode(tmp_path / "jax" / "ep0.dat", want)
    pdata_gen.save_episode(tmp_path / "port" / "ep0.dat", got)
    assert (tmp_path / "port" / "ep0.dat").read_bytes() == \
        (tmp_path / "jax" / "ep0.dat").read_bytes()


def test_data_gen_main_needs_the_simulator(tmp_path):
    argv = ["--data_dir", str(tmp_path), "--output", str(tmp_path / "out"),
            "--tasks", "pick_and_lift"]
    for mod in (jdata_gen, pdata_gen):
        with pytest.raises(ImportError, match="RLBench"):
            mod.main(argv)


@pytest.fixture(scope="module")
def clip_pair(tmp_path_factory):
    """An offline (tokenizer, model) pair with CLIP's real classes: a
    byte-level vocabulary and a randomly initialised 2-layer text model (as
    tests/test_instructions.py builds it)."""
    pytest.importorskip("transformers")
    import torch
    from transformers import CLIPTextConfig, CLIPTextModel, CLIPTokenizer
    from transformers.models.clip.tokenization_clip import bytes_to_unicode

    tmp = tmp_path_factory.mktemp("clip_vocab")
    chars = list(bytes_to_unicode().values())
    vocab = {ch: i for i, ch in enumerate(chars)}
    for ch in chars:
        vocab[ch + "</w>"] = len(vocab)
    for special in ("<|startoftext|>", "<|endoftext|>"):
        vocab[special] = len(vocab)
    (tmp / "vocab.json").write_text(json.dumps(vocab))
    (tmp / "merges.txt").write_text("#version: 0.2\n")
    tokenizer = CLIPTokenizer(str(tmp / "vocab.json"), str(tmp / "merges.txt"))
    config = CLIPTextConfig(vocab_size=len(vocab), hidden_size=512, intermediate_size=128,
                            num_hidden_layers=2, num_attention_heads=8,
                            max_position_embeddings=77)
    torch.manual_seed(0)
    model = CLIPTextModel(config)
    model.eval()
    return tokenizer, model


def test_preprocess_instructions_pickle_equals_jax(clip_pair, tmp_path):
    tokenizer, model = clip_pair
    annotations = [
        {"task": "pick_and_lift", "variation": 0, "instructions": ["pick it", "grab the cube"]},
        {"task": "pick_and_lift", "variation": 1, "instruction": "lift it up"},
        {"task": "push_button", "variation": 0, "instructions": ["push"]},
        {"variation": 0, "instructions": ["no task"]},
    ]
    ann = tmp_path / "annotations.json"
    ann.write_text(json.dumps(annotations))
    assert pinstr.load_annotations(ann) == jinstr.load_annotations(ann)
    argv = ["--tasks", "pick_and_lift", "push_button", "--variations", "0",
            "--annotations", str(ann)]
    jinstr.main(argv + ["--output", str(tmp_path / "jax.pkl")], tokenizer=tokenizer, model=model)
    pinstr.main(argv + ["--output", str(tmp_path / "port.pkl"), "--device", "cpu"],
                tokenizer=tokenizer, model=model)
    want = pickle.loads((tmp_path / "jax.pkl").read_bytes())
    got = pickle.loads((tmp_path / "port.pkl").read_bytes())
    assert got.keys() == want.keys()
    for task in want:
        assert got[task].keys() == want[task].keys()
        for var in want[task]:
            assert got[task][var].dtype == np.float32
            np.testing.assert_array_equal(got[task][var], want[task][var])
    with pytest.raises(RuntimeError, match="Too long"):
        pinstr.encode_instructions(["x" * 200], tokenizer=tokenizer, model=model, device="cpu")
    # a variation without annotations asks the simulator, which JAX's
    # simulator-less RLBenchEnv refuses with ImportError (kept)
    for mod, extra in ((jinstr, []), (pinstr, ["--device", "cpu"])):
        with pytest.raises(ImportError, match="RLBench"):
            mod.main(["--tasks", "pick_and_lift", "--variations", "3", "--annotations",
                      str(ann), "--output", str(tmp_path / "x.pkl")] + extra,
                     tokenizer=tokenizer, model=model)


def _tree(root):
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file()}


@pytest.mark.parametrize("fail_first", [0, 2])
def test_dataset_generator_tree_is_byte_identical_to_jax(tmp_path, fail_first):
    trees = {}
    for name, mod in (("jax", jgen), ("port", pgen)):
        np.random.seed(7)
        demo = mod.collect_and_save_episode(FlakyEnv(fail_first), tmp_path / name / "episode0",
                                            CAMS, variation=3, max_attempts=5)
        mod.verify_demo_and_rgbs(demo, tmp_path / name / "episode0", CAMS)
        trees[name] = _tree(tmp_path / name)
    assert len(trees["port"]) == 3 * 3 * len(CAMS) + 2  # 3 steps x 3 modalities, 2 pickles
    assert trees["port"] == trees["jax"]


class MasklessEnv(FlakyEnv):
    """Demos whose wrist camera has no mask: every save fails verification."""

    def get_demos(self, amount, live_demos):
        (demo,) = super().get_demos(amount, live_demos)
        for obs in demo:
            obs.wrist_mask = None
        return [demo]


@pytest.mark.parametrize("env", [FlakyEnv, MasklessEnv])
def test_dataset_generator_gives_up_and_cleans_up_as_jax(tmp_path, env):
    errors = {}
    for name, mod in (("jax", jgen), ("port", pgen)):
        path = tmp_path / name / "episode0"
        with pytest.raises(RuntimeError) as err:
            mod.collect_and_save_episode(env(99) if env is FlakyEnv else env(0), path, CAMS,
                                         variation=0, max_attempts=3)
        assert not path.exists()
        errors[name] = str(err.value).replace(str(tmp_path / name), "ROOT")
    assert errors["port"] == errors["jax"]
    assert "failed after 3 attempts" in errors["port"]


def test_save_demo_and_seed_replay_match_jax(tmp_path):
    for name, mod in (("jax", jgen), ("port", pgen)):
        demo = make_demo(4, seed=5)
        mod.save_demo(demo, tmp_path / name / "episode0", CAMS)
        assert demo[0].wrist_rgb is None
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")
    np.random.seed(11)
    first = pgen.collect_seeded_demo(FlakyEnv(0))
    np.random.uniform(size=10)
    again = pgen.collect_seeded_demo(FlakyEnv(0), random_seed_state=first.random_seed)
    np.testing.assert_array_equal(again.content_signature, first.content_signature)
