"""Converting the reference's PyTorch checkpoints into the port's format
(``move2hear_tpu_torch/utils/torch_import.py``, CLI
``scripts/torch_import_ref_ckpt.py``).

The reference-layout dicts are built from the oracle fixture's state-dict
manifests (``tests/fixtures/torch_oracle.npz`` ``shape/*``, the shapes of
the reference's own modules) under the real key prefixes, filled by
``tests/fixtures/torch_oracle_synth.py:synth_state_dict``. Every converted
dict must load strictly into the port's modules with its tensors unchanged,
and equal what the JAX package's converter (``move2hear_tpu/utils/
torch_import.py``) makes of the same dict, mapped through
``utils/params.py:from_jax``; a dict that was not converted must be refused
wherever the port loads one."""

import os
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from move2hear_tpu.utils import torch_import as jti
from move2hear_tpu_torch.eval.switch import merge_switch_policy_checkpoint
from move2hear_tpu_torch.main import main
from move2hear_tpu_torch.models import Move2HearPolicy
from move2hear_tpu_torch.models.policy import Move2HearPassiveWoMemoryPolicy
from move2hear_tpu_torch.rl.ppo import PASSIVE_KEYS, load_pretrained_passive_separators
from move2hear_tpu_torch.utils import torch_import as ti
from move2hear_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from move2hear_tpu_torch.utils.params import from_jax
from _torch_threads import cap_torch_threads

cap_torch_threads()

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "fixtures"))
from torch_oracle_synth import synth_state_dict  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(REPO, "tests", "fixtures", "torch_oracle.npz")
SCRIPT = os.path.join(REPO, ti.IMPORT_SCRIPT)
# fixture module -> its prefix in the reference's agent state dict
PASSIVE_PREFIXES = {
    "enc_bin": "actor_critic.binSep_enc.passive_sep_encoder.",
    "dec_bin": "actor_critic.binSep_dec.passive_sep_decoder.",
    "enc_mono": "actor_critic.bin2mono_enc.passive_sep_encoder.",
    "dec_mono": "actor_critic.bin2mono_dec.passive_sep_decoder.",
}
POLICY_PREFIXES = {
    "visual": "actor_critic.pol_net.visual_encoder.",
    "audio_bin": "actor_critic.pol_net.bin_encoder.",
    "audio_mem": "actor_critic.pol_net.monoNmonoFromMem_encoder.",
    "gru": "actor_critic.pol_net.state_encoder.",
}
# the adapter level of each U-Net: binSep_enc -> passive_sep_encoder.
ADAPTER = {p.split(".")[1]: p.split(".")[2] + "." for p in PASSIVE_PREFIXES.values()}
NUM_ACTIONS, HIDDEN = 3, 512  # the fixture's GRU is the reference's hidden 512


@pytest.fixture(scope="module")
def fx():
    return np.load(FIX)


def _module_sd(fx, mod):
    shapes = {k.split(f"shape/{mod}/", 1)[1]: tuple(fx[k])
              for k in fx.files if k.startswith(f"shape/{mod}/")}
    return _tensors(synth_state_dict(shapes, int(fx[f"seed/{mod}"])))


def _tensors(arrays):
    return {k: torch.from_numpy(v) for k, v in arrays.items()}


def _reference_passive(fx):
    return {p + k: v for mod, p in PASSIVE_PREFIXES.items() for k, v in _module_sd(fx, mod).items()}


def _reference_agent(fx, use_ddppo, seed=0):
    sd = _reference_passive(fx)
    mem = "mem_ddppo" if use_ddppo else "mem_bn"
    for mod, prefix in {**POLICY_PREFIXES, mem: "actor_critic.acoustic_mem."}.items():
        sd.update({prefix + k: v for k, v in _module_sd(fx, mod).items()})
    sd.update({f"actor_critic.{k}": v for k, v in _tensors(synth_state_dict({
        "action_dist.linear.weight": (NUM_ACTIONS, HIDDEN), "action_dist.linear.bias": (NUM_ACTIONS,),
        "critic.fc.weight": (1, HIDDEN), "critic.fc.bias": (1,),
    }, seed)).items()})
    return sd


def _policy(use_ddppo):
    """The fixture's agent: hidden 512, RGB-D visual encoder."""
    return Move2HearPolicy(NUM_ACTIONS, HIDDEN, use_ddppo=use_ddppo)


def _small_policy(use_ddppo=True):
    """As the eval configs build it (EXTRA_DEPTH), at hidden 32."""
    return Move2HearPolicy(NUM_ACTIONS, 32, extra_depth=True, use_ddppo=use_ddppo)


def _port_key(ref_key):
    top, _, rest = ref_key[len("actor_critic."):].partition(".")
    return f"{top}.{rest[len(ADAPTER[top]):]}" if top in ADAPTER else f"{top}.{rest}"


def _assert_same_values(converted, reference):
    """Each converted tensor equals its source array under the port's key."""
    assert len(converted) == len(reference)
    for ref_key, value in reference.items():
        assert torch.equal(converted[_port_key(ref_key)], value), ref_key


def _assert_matches_jax(converted, reference, use_ddppo=None):
    """The port's conversion equals the JAX package's conversion of the same
    reference dict, mapped back through ``from_jax``: tensor for tensor,
    but for ``num_batches_tracked``, which the flax tree lacks."""
    ref = {k: v.numpy() for k, v in reference.items()}
    if use_ddppo is None:
        params, stats = jti.convert_passive_state_dict(ref)
    else:
        params, stats = jti.convert_agent_state_dict(ref, use_ddppo=use_ddppo)
    expected = from_jax(params, stats)
    assert set(expected) == set(converted)
    for k, v in expected.items():
        if not k.endswith("num_batches_tracked"):
            assert converted[k].dtype == v.dtype and torch.equal(converted[k], v), k


@pytest.mark.parametrize("use_ddppo", [True, False], ids=["ddppo", "batchnorm"])
def test_agent_checkpoint_converts_and_loads_strictly(fx, use_ddppo):
    raw = {"state_dict": _reference_agent(fx, use_ddppo), "config": object()}
    assert ti.detect_layout(raw) == "agent"
    assert ti.detect_use_ddppo(raw["state_dict"]) is use_ddppo
    out = ti.convert_checkpoint(raw, source="ckpt.7.pth")
    assert out == {"state_dict": out["state_dict"], "config": {}, "imported_from": "ckpt.7.pth"}
    _policy(use_ddppo).load_state_dict(out["state_dict"])  # strict
    _assert_same_values(out["state_dict"], raw["state_dict"])
    _assert_matches_jax(out["state_dict"], raw["state_dict"], use_ddppo)
    nbt = out["state_dict"]["binSep_enc.cnn.0.1.num_batches_tracked"]
    assert nbt.dtype == torch.long and nbt.shape == ()


def test_passive_checkpoint_converts_and_loads_strictly(fx):
    raw = {"state_dict": _reference_passive(fx)}
    assert ti.detect_layout(raw) == "passive"
    out = ti.convert_checkpoint(raw)
    assert set(out) == {"state_dict", "config", "imported_from"}
    Move2HearPassiveWoMemoryPolicy().load_state_dict(out["state_dict"])  # strict
    _assert_same_values(out["state_dict"], raw["state_dict"])
    _assert_matches_jax(out["state_dict"], raw["state_dict"])
    # as RL training's pretrained separators: all 124 passive tensors copied
    policy = _policy(True)
    load_pretrained_passive_separators(policy, out["state_dict"])
    own = policy.state_dict()
    for k, v in out["state_dict"].items():
        assert torch.equal(own[k], v), k
    # a state dict saved without num_batches_tracked (torch before 0.4.1)
    old = {k: v for k, v in raw["state_dict"].items() if not k.endswith("num_batches_tracked")}
    Move2HearPassiveWoMemoryPolicy().load_state_dict(ti.convert_passive_state_dict(old))


def test_switch_checkpoint_converts_and_loads_strictly(fx):
    raw = {"state_dict_nav": _reference_agent(fx, True, seed=1), "config_nav": object(),
           "state_dict_qualImprov": _reference_agent(fx, True, seed=2),
           "config_qualImprov": object()}
    assert ti.detect_layout(raw) == "switch"
    out = ti.convert_checkpoint(raw)
    assert out["config_nav"] == {} and out["config_qualImprov"] == {}
    for role in ("nav", "qualImprov"):
        assert ti.detect_use_ddppo(raw[f"state_dict_{role}"])
        _policy(True).load_state_dict(out[f"state_dict_{role}"])
        _assert_same_values(out[f"state_dict_{role}"], raw[f"state_dict_{role}"])
        _assert_matches_jax(out[f"state_dict_{role}"], raw[f"state_dict_{role}"], True)
    assert not torch.equal(out["state_dict_nav"]["critic.fc.weight"],
                           out["state_dict_qualImprov"]["critic.fc.weight"])


def _to_reference(state_dict):
    """The port's state dict under the reference's prefixes."""
    out = {}
    for k, v in state_dict.items():
        top, _, rest = k.partition(".")
        adapter = ADAPTER.get(top)
        out["actor_critic." + (f"{top}.{adapter}{rest}" if adapter else k)] = v
    return out


@pytest.mark.parametrize("use_ddppo", [True, False], ids=["ddppo", "batchnorm"])
def test_round_trip_gives_back_equal_tensors(use_ddppo):
    torch.manual_seed(3)
    own = _small_policy(use_ddppo).state_dict()
    ref = _to_reference(own)
    back = ti.convert_agent_state_dict(ref)
    assert ti.detect_use_ddppo(ref) is use_ddppo
    assert set(back) == set(own)
    for k, v in own.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k
    _assert_matches_jax(back, ref, use_ddppo)


def _fake_yacs():
    """A module standing for yacs, whose ``CfgNode`` the reference pickles as
    its config; removed again before the file is read."""
    mod = types.ModuleType("fake_yacs_config")

    class CfgNode(dict):
        pass

    CfgNode.__module__, CfgNode.__qualname__ = mod.__name__, "CfgNode"
    mod.CfgNode = CfgNode
    return mod


def test_cli_converts_a_reference_file_that_the_evaluator_then_runs(tmp_path, monkeypatch):
    """A reference RL checkpoint (hidden 32, a pickled config object of a
    module this process cannot import) -> the import CLI -> the port's eval
    CLI on the CPU, falling back to the eval config."""
    yacs = _fake_yacs()
    monkeypatch.setitem(sys.modules, yacs.__name__, yacs)
    torch.manual_seed(4)
    own = _small_policy().state_dict()
    ref_path, out_path = str(tmp_path / "ckpt.3.pth"), str(tmp_path / "port.pth")
    torch.save({"state_dict": _to_reference(own), "config": yacs.CfgNode(SEED=1)}, ref_path)
    monkeypatch.delitem(sys.modules, yacs.__name__)
    res = subprocess.run([sys.executable, SCRIPT, ref_path, out_path], capture_output=True,
                         text=True, cwd=str(tmp_path))
    assert res.returncode == 0, res.stderr
    assert "imported agent checkpoint" in res.stdout
    ckpt = load_checkpoint(out_path)  # weights_only: plain tensors and dicts
    assert ckpt["imported_from"] == ref_path and ckpt["config"] == {}
    for k, v in own.items():
        assert torch.equal(ckpt["state_dict"][k], v), k
    ev = main(["--run-type", "eval", "--exp-config", "configs/test/nearTarget.yaml",
               "--model-dir", str(tmp_path / "eval"), "--device", "cpu",
               "EVAL_CKPT_PATH_DIR", out_path, "RL.PPO.hidden_size", "32",
               "EVAL_EPISODE_COUNT", "2", "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", "2",
               "TPU.DEVICE_EVAL_MIN_EPISODES", "2", "TPU.MAX_RIR_LENGTH", "400"])
    assert ev.last_eval[1]["episodes"] == 2
    assert np.isfinite(ev.last_eval[0]["mono_l2_last"]["mean"])
    shutil.rmtree(tmp_path)  # the reference and converted checkpoints


def test_an_unconverted_reference_dict_is_refused_naming_the_script(tmp_path):
    torch.manual_seed(5)
    own = _small_policy().state_dict()
    ref = _to_reference(own)
    with pytest.raises(ValueError, match=ti.IMPORT_SCRIPT):
        load_pretrained_passive_separators(_small_policy(), ref)
    ref_path = str(tmp_path / "ref.pth")
    save_checkpoint(ref_path, {"state_dict": ref, "config": {}})
    with pytest.raises(ValueError, match=ti.IMPORT_SCRIPT):
        main(["--run-type", "eval", "--exp-config", "configs/test/nearTarget.yaml",
              "--model-dir", str(tmp_path / "eval"), "--device", "cpu",
              "EVAL_CKPT_PATH_DIR", ref_path, "RL.PPO.hidden_size", "32",
              "EVAL_EPISODE_COUNT", "2", "TPU.DEVICE_EVAL_MIN_EPISODES", "2",
              "TPU.MAX_RIR_LENGTH", "400"])
    port_path = str(tmp_path / "port.pth")
    save_checkpoint(port_path, {"state_dict": own, "config": {}})
    with pytest.raises(ValueError, match=ti.IMPORT_SCRIPT):
        merge_switch_policy_checkpoint(ref_path, port_path, str(tmp_path / "switch.pth"))
    # a dict in the port's layout is not a reference checkpoint
    with pytest.raises(ValueError, match="not a reference checkpoint"):
        ti.convert_checkpoint({"state_dict": own})
    assert set(PASSIVE_KEYS) == set(ti.PASSIVE_MODULES)
