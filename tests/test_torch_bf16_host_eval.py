"""The port's host evaluator in bfloat16 (TPU.COMPUTE_DTYPE bfloat16) against
the JAX package's on the CPU, its programs compiled without excess
precision: deterministic actions, 2 near-target episodes; equal actions,
and the per-step STFT-L2s under the discriminator of
tests/test_torch_bf16_models.py, JAX's float32 evaluation the yardstick
(split from tests/test_torch_bf16_host.py)."""

import shutil

import numpy as np
import pytest
import torch

from move2hear_tpu.env.micro_scene import build_micro_scene as j_build_micro_scene
from move2hear_tpu_torch.env.micro_scene import build_micro_scene
from test_torch_bf16_models import discriminate
from test_torch_host_eval import HID, NEAR, _run_both
from test_torch_bf16_host import _no_excess_precision
from _torch_threads import cap_torch_threads

cap_torch_threads()


def test_bf16_host_evaluator_matches_the_jax_host_evaluator(tmp_path):
    opts = ["RL.PPO.hidden_size", str(HID), "RL.PPO.deterministic_eval", "True",
            "EVAL_EPISODE_COUNT", "2", "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", "3",
            "TPU.MAX_RIR_LENGTH", "400"]
    runs = {}
    with pytest.MonkeyPatch.context() as mp:
        _no_excess_precision(mp)
        for dtype in ("bfloat16", "float32"):
            runs[dtype] = _run_both(
                tmp_path / dtype, NEAR, opts + ["TPU.COMPUTE_DTYPE", dtype],
                j_build_micro_scene(rows=3, cols=3, num_episodes=4, rir_length=400),
                build_micro_scene(rows=3, cols=3, num_episodes=4, rir_length=400), False)
    _, _, j_dump, t_dump, j_actions, t_actions, _ = runs["bfloat16"]
    f32_dump, f32_actions = runs["float32"][2], runs["float32"][4]
    assert t_actions == j_actions == f32_actions and len(t_actions) == 2
    for m in ("mono_l2", "mem_l2", "bin_l2"):
        keys = sorted(j_dump)
        discriminate(torch.tensor(np.concatenate([t_dump[k][m] for k in keys])),
                     np.concatenate([j_dump[k][m] for k in keys]),
                     np.concatenate([f32_dump[k][m] for k in keys]), f"host eval {m}")
    shutil.rmtree(tmp_path)
