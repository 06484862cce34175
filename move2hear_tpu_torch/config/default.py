"""Experiment + task config trees, mirroring the reference's two-tree yacs
design (``audio_separation/config/default.py:15-205``): an experiment tree
with trainer/RL/pretrain knobs, and a task tree (`TASK_CONFIG`) with
simulator/sensor/audio settings. Merge order: defaults -> experiment YAML ->
BASE_TASK_CONFIG YAML -> CLI opts, then frozen.

The keys are the JAX package's, so the YAMLs under configs/ merge
unchanged. Of its `TPU` group the port keeps, under the same name, only the
keys its code reads: COMPUTE_DTYPE, DEVICE_ENV, DEVICE_EVAL_MIN_EPISODES,
COLLECT_UNROLL, FUSED_CYCLE, PAIRWISE_FUSION, MAX_RIR_LENGTH,
PRECOMPUTE_RIR_RFFT, MAX_DEVICE_BANK_BYTES, SEP_SLAB_DTYPE, SEP_REFIT_DTYPE,
SUB_BANK_ROWS, SUB_BANK_DTYPE, SUB_PREFETCH, RIR_MODE, STATS_FETCH_INTERVAL
and REPORT_MFU.
"""

import os
from typing import List, Optional, Union

from move2hear_tpu_torch.utils.config_tree import Config

CONFIG_FILE_SEPARATOR = ","


def default_config() -> Config:
    c = Config()
    c.SEED = 0
    c.BASE_TASK_CONFIG_PATH = ""
    c.CMD_TRAILING_OPTS = []
    c.TRAINER_NAME = "ppo"
    c.ENV_NAME = "AAViSSEnv"
    c.MODEL_DIR = ""
    c.TENSORBOARD_DIR = "tb"
    c.VIDEO_OPTION = []
    c.RESUME_CKPT = ""
    c.EVAL_CKPT_PATH_DIR = "data/checkpoints"
    c.NUM_PROCESSES = 16
    c.SENSORS = ["RGB_SENSOR", "DEPTH_SENSOR"]
    c.CHECKPOINT_FOLDER = "data/checkpoints"
    c.NUM_UPDATES = 10000
    c.LOG_INTERVAL = 10
    c.LOG_FILE = "train.log"
    c.CHECKPOINT_INTERVAL = 50
    c.USE_VECENV = True
    c.USE_SYNC_VECENV = False
    c.EXTRA_RGB = False
    c.EXTRA_DEPTH = False
    c.DEBUG = False
    c.NUM_SOUNDS_IN_MIX = 2
    c.COMPUTE_EVAL_METRICS = False
    c.EVAL_METRICS_TO_COMPUTE = ["si_sdr"]
    c.EPS_SCENES = []
    c.EPS_SCENES_N_IDS = []
    c.EVAL_EPISODE_COUNT = 1000
    c.JOB_ID = 1
    c.OVERWRITE_MODEL_DIR = False   # non-interactive variant of default.py:259-270

    c.EVAL = Config()
    c.EVAL.SPLIT = "val"
    c.EVAL.USE_CKPT_CONFIG = True
    c.EVAL.EPISODE_COUNT = 1000

    c.RL = Config()
    c.RL.SUCCESS_REWARD = 10.0
    c.RL.SLACK_REWARD = -0.01
    c.RL.WITH_DISTANCE_REWARD = True
    c.RL.DISTANCE_REWARD_SCALE = 1.0

    ppo = Config()
    ppo.num_updates_per_cycle = 1
    ppo.pretrained_passive_separators_ckpt = ""
    ppo.train_passive_separators = False
    ppo.clip_param = 0.2
    ppo.ppo_epoch = 4
    ppo.num_mini_batch = 16
    ppo.value_loss_coef = 0.5
    ppo.bin_separation_loss_coef = 1.0
    ppo.mono_conversion_loss_coef = 1.0
    ppo.entropy_coef = 0.01
    ppo.lr_pol = 1e-3
    ppo.lr_sep = 1e-3
    ppo.eps = 1e-5
    ppo.max_grad_norm = 0.5
    ppo.num_steps = 5
    ppo.hidden_size = 512
    ppo.use_gae = True
    ppo.use_linear_lr_decay = False
    ppo.use_linear_clip_decay = False
    ppo.gamma = 0.99
    ppo.tau = 0.95
    ppo.reward_window_size = 50
    ppo.nav_reward_weight = 0.0
    ppo.sep_reward_weight = 1.0
    ppo.extra_reward_multiplier = 10.0
    ppo.deterministic_eval = False
    ppo.use_ddppo = False
    ppo.ddppo_distrib_backend = "NCCL"  # or GLOO (parallel/ddppo.py)
    ppo.short_rollout_threshold = 0.25
    ppo.sync_frac = 0.6
    ppo.master_port = 8738
    ppo.master_addr = "127.0.0.1"
    ppo.switch_policy = False
    ppo.time_thres_for_pol_switch = 80
    c.RL.PPO = ppo

    c.Pretrain = Config()
    c.Pretrain.Passive = Config()
    c.Pretrain.Passive.lr = 5.0e-4
    c.Pretrain.Passive.eps = 1.0e-5
    c.Pretrain.Passive.max_grad_norm = 0.8
    c.Pretrain.Passive.NUM_EPOCHS = 1000
    c.Pretrain.Passive.BATCH_SIZE = 64

    # --- device-route knobs (the JAX package's `TPU` group) ---------------
    c.TPU = Config()
    c.TPU.COMPUTE_DTYPE = "float32"  # or "bfloat16": the policy's compute
    # dtype in training, the host evaluator and the pretrain (parameters,
    # Adam state and losses stay float32); the device evaluator runs float32
    c.TPU.DEVICE_ENV = True          # evaluate on the batched device env
    c.TPU.DEVICE_EVAL_MIN_EPISODES = 64  # route eval to the batched device
    # evaluator at/above this episode count; below it the host evaluator
    # (eval/evaluator.py) runs
    c.TPU.COLLECT_UNROLL = 1  # the JAX package's lax.scan unroll of the
    # collect's time loop: 0 or more (a negative value raises ValueError);
    # the port's collect is a Python loop, which every value runs alike
    c.TPU.FUSED_CYCLE = False  # the JAX package runs a whole cycle as one
    # program; here the same loops run under its fused route's rules:
    # frames stored in the rollouts (no pose bank), no preemptive sync, no
    # sub-banks (auto takes the host path instead, sub raises ValueError),
    # no REPORT_MFU, the lr and clip decay computed in float32
    # (1 - float32(update) / NUM_UPDATES), SEP_SLAB_DTYPE unapplied
    c.TPU.PAIRWISE_FUSION = False  # the JAX package fuses each collect with
    # its policy update; here the FUSED_CYCLE rules above but the decay and
    # SEP_SLAB_DTYPE, which stay the default route's
    c.TPU.MAX_RIR_LENGTH = 16000     # static pad length for RIR tensors
    c.TPU.PRECOMPUTE_RIR_RFFT = True  # cache rffts of the whole RIR bank,
    # removing the per-step RIR forward FFTs
    c.TPU.MAX_DEVICE_BANK_BYTES = 40 * 1024**3  # device-env gate: the dense
    # banks when they fit it, else the RIR sub-banks when they fit it, else
    # the host env path. Half of an H100's 80 GB: the other
    # half holds the model, Adam state, activations and the cuDNN and cuFFT
    # workspaces (the JAX package's 8 GiB is half of a 16 GiB TPU v5e)
    c.TPU.SUB_BANK_ROWS = 0  # slots of the RIR sub-bank (env/sub_bank.py);
    # 0 = one window's need grown into the budget the fixed banks leave, at
    # most one a (scene, source) key
    c.TPU.SEP_SLAB_DTYPE = "float32"  # or "bfloat16": storage of the
    # separator refit's three (T_total, N, 512, 32, 1) slabs
    c.TPU.SEP_REFIT_DTYPE = ""  # "bfloat16" or "float32": the compute dtype
    # of the acoustic-memory refit only; "" keeps COMPUTE_DTYPE
    c.TPU.SUB_BANK_DTYPE = "float32"  # or "bfloat16": the sub-bank slab's
    # storage; the gather widens rows to float32 for the render
    c.TPU.SUB_PREFETCH = True  # assemble and upload the next window's rows
    # after each policy update is queued, while the device runs it
    c.TPU.RIR_MODE = "auto"  # dense, sub or host forces that route, skipping
    # the MAX_DEVICE_BANK_BYTES gate
    c.TPU.STATS_FETCH_INTERVAL = 2  # the trainer fetches the packed logging
    # stats to the host every N cycles
    c.TPU.REPORT_MFU = False  # count the FLOPs of the first training cycle
    # and expose them as trainer.mfu_info (device path, a world of one)

    c.TASK_CONFIG = default_task_config()
    return c


def default_task_config() -> Config:
    t = Config()
    t.ENVIRONMENT = Config()
    t.ENVIRONMENT.MAX_EPISODE_STEPS = 20

    t.SIMULATOR = Config()
    t.SIMULATOR.TYPE = "AAViSSSim"
    t.SIMULATOR.SEED = -1
    t.SIMULATOR.SCENE_DATASET = "mp3d"
    t.SIMULATOR.MAX_EPISODE_STEPS = 20
    t.SIMULATOR.GRID_SIZE = 1.0
    t.SIMULATOR.USE_RENDERED_OBSERVATIONS = True
    t.SIMULATOR.RENDERED_OBSERVATIONS = "data/scene_observations"
    t.SIMULATOR.USE_SYNC_VECENV = False

    a = Config()
    a.MONO_DIR = "data/audio_data/train"
    a.RIR_DIR = "data/binaural_rirs/mp3d"
    a.META_DIR = "data/metadata/mp3d"
    a.PASSIVE_DATASET_VERSION = "v1"
    a.SOURCE_AGENT_LOCATION_DATAPOINTS_DIR = "data/passive_datasets/"
    a.PASSIVE_TRAIN_AUDIO_DIR = "data/audio_data/train"
    a.PASSIVE_NONOVERLAPPING_VAL_AUDIO_DIR = "data/audio_data/val"
    a.NUM_PASSIVE_DATAPOINTS_PER_SCENE = 30000
    a.NUM_PASSIVE_DATAPOINTS_PER_SCENE_EVAL = 1000
    a.GRAPH_FILE = "graph.pkl"
    a.POINTS_FILE = "points.txt"
    a.NUM_WORKER = 4
    a.BATCH_SIZE = 128
    a.GT_MONO_MAG_NORM = 0.0
    a.NORM_TYPE = "l2"
    a.RIR_SAMPLING_RATE = 16000
    t.SIMULATOR.AUDIO = a

    t.TASK = Config()
    t.TASK.TYPE = "AAViSS"
    t.TASK.SENSORS = [
        "MIXED_BIN_AUDIO_MAG_SENSOR",
        "MIXED_BIN_AUDIO_PHASE_SENSOR",
        "GT_MONO_COMPONENTS_SENSOR",
        "GT_BIN_COMPONENTS_SENSOR",
        "TARGET_CLASS_SENSOR",
    ]
    t.TASK.MEASUREMENTS = [
        "GEODESIC_DISTANCE_TO_TARGET_AUDIO_SOURCE",
        "NORMALIZED_GEODESIC_DISTANCE_TO_TARGET_AUDIO_SOURCE",
    ]
    t.TASK.POSSIBLE_ACTIONS = ["MOVE_FORWARD", "TURN_LEFT", "TURN_RIGHT"]
    t.TASK.MIXED_BIN_AUDIO_MAG_SENSOR = Config({"TYPE": "MixedBinAudioMagSensor", "FEATURE_SHAPE": [512, 32, 2]})
    t.TASK.MIXED_BIN_AUDIO_PHASE_SENSOR = Config({"TYPE": "MixedBinAudioPhaseSensor", "FEATURE_SHAPE": [512, 32, 2]})
    t.TASK.GT_MONO_COMPONENTS_SENSOR = Config({"TYPE": "GtMonoComponentsSensor", "FEATURE_SHAPE": [512, 32, 2]})
    t.TASK.GT_BIN_COMPONENTS_SENSOR = Config({"TYPE": "GtBinComponentsSensor", "FEATURE_SHAPE": [512, 32, 4]})
    t.TASK.TARGET_CLASS_SENSOR = Config({"TYPE": "TargetClassSensor"})

    t.SIMULATOR_SENSORS = Config()
    t.SIMULATOR_SENSORS.RGB_SENSOR = Config({"WIDTH": 128, "HEIGHT": 128})
    t.SIMULATOR_SENSORS.DEPTH_SENSOR = Config({"WIDTH": 128, "HEIGHT": 128})

    t.DATASET = Config()
    t.DATASET.TYPE = "AAViSS"
    t.DATASET.SPLIT = "train"
    t.DATASET.VERSION = "v1"
    t.DATASET.SCENES_DIR = "data/scene_datasets"
    t.DATASET.DATA_PATH = "data/datasets/audio_separation/{version}/{split}/{split}.json.gz"
    return t


def get_task_config(
    config_paths: Optional[Union[List[str], str]] = None,
    opts: Optional[list] = None,
) -> Config:
    config = default_task_config()
    if config_paths:
        if isinstance(config_paths, str):
            config_paths = config_paths.split(CONFIG_FILE_SEPARATOR)
        for path in config_paths:
            config.merge_from_file(path)
    if opts:
        config.merge_from_list(opts)
    return config.freeze()


def get_config(
    config_paths: Optional[Union[List[str], str]] = None,
    opts: Optional[list] = None,
    model_dir: Optional[str] = None,
    run_type: Optional[str] = None,
) -> Config:
    """Build the merged, frozen experiment config (default.py:228-288):
    defaults -> experiment YAML(s) -> BASE_TASK_CONFIG YAML -> CLI opts, with
    model-dir-derived output paths and the GT-sensor channel scaling by
    NUM_SOUNDS_IN_MIX."""
    config = default_config()
    if config_paths:
        if isinstance(config_paths, str):
            config_paths = config_paths.split(CONFIG_FILE_SEPARATOR)
        for path in config_paths:
            config.merge_from_file(path)

    if config.BASE_TASK_CONFIG_PATH:
        config.TASK_CONFIG = get_task_config(config.BASE_TASK_CONFIG_PATH).clone()
        config.TASK_CONFIG.defrost()

    if opts:
        config.CMD_TRAILING_OPTS = list(opts)
        config.merge_from_list(opts)

    if model_dir is None:
        raise ValueError("set --model-dir")
    config.MODEL_DIR = model_dir
    config.TENSORBOARD_DIR = os.path.join(model_dir, config.TENSORBOARD_DIR)
    config.CHECKPOINT_FOLDER = os.path.join(model_dir, "data")
    config.LOG_FILE = os.path.join(model_dir, os.path.basename(config.LOG_FILE))
    # the reference unconditionally overwrites EVAL_CKPT_PATH_DIR with the
    # derived dir (ref default.py:257), which makes its documented
    # "path to ckpt" usage unreachable; honor an explicit CLI override
    # (single-ckpt eval, e.g. merged switch ckpts) and derive otherwise
    if "EVAL_CKPT_PATH_DIR" not in (opts or []):
        config.EVAL_CKPT_PATH_DIR = os.path.join(model_dir, "data")

    # non-interactive variant of the reference's overwrite prompt
    # (default.py:259-270): wipe stale output dirs only when asked to
    if run_type == "train" and config.OVERWRITE_MODEL_DIR:
        import shutil

        for d in (config.TENSORBOARD_DIR, config.CHECKPOINT_FOLDER):
            if os.path.exists(d):
                shutil.rmtree(d)

    config.TASK_CONFIG.SIMULATOR.USE_SYNC_VECENV = config.USE_SYNC_VECENV
    # GT component channels scale with the number of sources (default.py:275-276)
    config.TASK_CONFIG.TASK.GT_MONO_COMPONENTS_SENSOR.FEATURE_SHAPE[2] = (
        2 * config.NUM_SOUNDS_IN_MIX
    )
    config.TASK_CONFIG.TASK.GT_BIN_COMPONENTS_SENSOR.FEATURE_SHAPE[2] = (
        4 * config.NUM_SOUNDS_IN_MIX
    )
    config.TASK_CONFIG.SIMULATOR.MAX_EPISODE_STEPS = (
        config.TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS
    )

    if config.RL.PPO.switch_policy:
        config.EVAL.USE_CKPT_CONFIG = False
        config.NUM_PROCESSES = 1

    return config.freeze()
