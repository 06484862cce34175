"""The post-processing CLIs that stand in for the reference's notebooks
(scripts/best_ckpt.py, scripts/link_ckpts.py, scripts/separation_quality.py)
on the port's own outputs, on the CPU: a tiny training run writes
ckpt.0-2.pth; the device evaluator evaluates each and the host evaluator
the last; the scripts run as subprocesses on those files.

- best_ckpt.py names the index whose JSON mean of mem_l2_last is the
  lowest, and each JSON mean is the mean of the pickle's last-step values;
- link_ckpts.py --every 2 links ckpt.0 and ckpt.2 densely as ckpt.0 and
  ckpt.1, and the polling evaluation (``--run-type eval``'s loop over a
  folder) of the linked folder reproduces those checkpoints' evaluations;
- separation_quality.py's means and counts equal the last-step means and
  episode counts computed here from each pickle. Both evaluators dump the
  host evaluator's per-episode layout (lists of per-step floats), as the
  JAX package's two evaluators do (move2hear_tpu/eval/device_evaluator.py:
  510-512), so the script reads both through its per-episode branch; its
  per-batch branch reads (T, N) arrays that neither package writes."""

import glob
import json
import os
import pickle
import shutil
import subprocess
import sys

import numpy as np

import move2hear_tpu_torch.rl.trainer as ttrainer
from move2hear_tpu_torch.config import get_config
from move2hear_tpu_torch.rl.trainer import PPOTrainer
from move2hear_tpu_torch.utils.tb import TensorboardWriter
from _torch_threads import cap_torch_threads

cap_torch_threads()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPLIT = "test_nearTarget"  # configs/test/nearTarget.yaml's EVAL.SPLIT
TRAIN = ["NUM_PROCESSES", "2", "NUM_UPDATES", "2", "RL.PPO.num_updates_per_cycle", "1",
         "CHECKPOINT_INTERVAL", "1", "LOG_INTERVAL", "1000", "RL.PPO.hidden_size", "32",
         "RL.PPO.num_steps", "2", "RL.PPO.ppo_epoch", "1",
         "RL.PPO.pretrained_passive_separators_ckpt", "",
         "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", "3", "TPU.MAX_RIR_LENGTH", "400"]
EVAL = ["EVAL_EPISODE_COUNT", "2", "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", "3",
        "TPU.MAX_RIR_LENGTH", "400", "EVAL_METRICS_TO_COMPUTE", "['si_sdr', 'si_sdri']"]
METRICS = ("si_sdr", "si_sdri")


def _script(name, *args):
    out = subprocess.run([sys.executable, os.path.join("scripts", name), *map(str, args)],
                         cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return out.stdout


def _evaluator(model_dir, route, ckpt_dir=""):
    """A trainer that evaluates into `model_dir` on the device (`route`
    "device": at least DEVICE_EVAL_MIN_EPISODES episodes) or the host
    evaluator."""
    opts = [*EVAL, "TPU.DEVICE_EVAL_MIN_EPISODES", "2" if route == "device" else "3"]
    if ckpt_dir:
        opts += ["EVAL_CKPT_PATH_DIR", ckpt_dir]
    trainer = PPOTrainer(get_config("configs/test/nearTarget.yaml", opts, str(model_dir), "eval"),
                         device="cpu")
    return trainer


def _evaluate(model_dir, route, ckpt, index):
    trainer = _evaluator(model_dir, route)
    trainer._eval_checkpoint(ckpt, index)
    assert trainer._eval_route == route
    with open(os.path.join(model_dir, f"{SPLIT}_stats_ckpt_{index}_0.json")) as f:
        return json.load(f)


def _last_step_summary(path):
    """separation_quality.py's summary computed here: per episode the last
    step's STFT-L2s and SI metrics, their means and counts."""
    with open(path, "rb") as f:
        dump = pickle.load(f)
    for ep in dump.values():
        assert isinstance(ep, dict) and not any(isinstance(v, np.ndarray) for v in ep.values())
        assert all(type(x) is float for k in ("mono_l2", "mem_l2", "bin_l2") for x in ep[k])
    values = {}
    for ep in dump.values():
        for k in ("mono_l2", "mem_l2", "bin_l2"):
            values.setdefault(f"{k}_last", []).append(ep[k][-1])
        for head in ("mono", "monoFromMem"):
            for m in METRICS:
                values.setdefault(f"{head}_{m}_last", []).append(ep["quality"][-1][head][m])
    return {k: (float(np.mean(v)), len(v)) for k, v in values.items()}, len(dump)


def test_postprocessing_clis_read_the_ports_outputs(tmp_path, monkeypatch):
    monkeypatch.setattr(ttrainer, "TensorboardWriter", lambda *a, **k: TensorboardWriter(""))
    monkeypatch.setenv("INTERRUPTED_STATE_DIR", str(tmp_path / "interrupted"))
    train_cfg = get_config("configs/train/nearTarget.yaml", TRAIN, str(tmp_path / "train"), "train")
    PPOTrainer(train_cfg, device="cpu").train()
    data = train_cfg.CHECKPOINT_FOLDER
    ckpts = [os.path.join(data, f"ckpt.{i}.pth") for i in range(3)]
    assert sorted(glob.glob(os.path.join(data, "ckpt.*.pth"))) == ckpts

    # best_ckpt.py over the device evaluator's JSON dumps of every checkpoint
    dev = tmp_path / "device_eval"
    stats = [_evaluate(dev, "device", c, i) for i, c in enumerate(ckpts)]
    for i, s in enumerate(stats):
        own, n_eps = _last_step_summary(dev / f"eval_metrics_ckpt_{i}.pkl")
        assert n_eps == 2
        np.testing.assert_allclose(s["mem_l2_last"]["mean"], own["mem_l2_last"][0], rtol=1e-12)
    best = json.loads(_script("best_ckpt.py", dev, "--metric", "mem_l2_last", "--split", SPLIT))
    means = [s["mem_l2_last"]["mean"] for s in stats]
    assert best["best_ckpt_index"] == int(np.argmin(means))
    assert best["mem_l2_last"] == min(means)

    # link_ckpts.py --every 2, then the polling evaluation of the links
    linked = tmp_path / "linked"
    out = _script("link_ckpts.py", data, linked, "--every", "2")
    assert "linked 2 of 3 checkpoints" in out
    assert sorted(os.listdir(linked)) == ["ckpt.0.pth", "ckpt.1.pth"]
    for dst, src in (("ckpt.0.pth", 0), ("ckpt.1.pth", 2)):
        assert os.path.realpath(linked / dst) == os.path.realpath(ckpts[src])
    poll = tmp_path / "poll_eval"
    trainer = _evaluator(poll, "device", ckpt_dir=str(linked))
    trainer._eval_poll_once = True
    trainer.eval()
    for dst, src in ((0, 0), (1, 2)):
        with open(poll / f"{SPLIT}_stats_ckpt_{dst}_0.json") as f:
            assert json.load(f) == stats[src], (dst, src)
    assert not os.path.exists(poll / f"{SPLIT}_stats_ckpt_2_0.json")

    # separation_quality.py on the device and the host evaluators' dumps
    host = tmp_path / "host_eval"
    _evaluate(host, "host", ckpts[-1], 2)
    for model_dir in (dev, host):
        summary = json.loads(_script("separation_quality.py", model_dir, "--ckpt", 2,
                                     "--metrics", *METRICS))
        own, n_eps = _last_step_summary(model_dir / "eval_metrics_ckpt_2.pkl")
        assert set(summary) == set(own), (model_dir, sorted(summary))
        for k, (mean, n) in own.items():
            assert summary[k]["n"] == n == n_eps, (model_dir, k)
            np.testing.assert_allclose(summary[k]["mean"], mean, rtol=1e-12, err_msg=k)
    shutil.rmtree(tmp_path)
