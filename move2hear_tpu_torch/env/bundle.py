"""Scene bundles from config files in the SoundSpaces layout, the
reference's env construction (``common/env_utils.py:531-687``:
make_dataset + get_scenes_to_load + per-scene habitat sims reading
SIMULATOR.AUDIO.*), the JAX package's ``env/bundle.py``:

  - episodes: ``DATASET.DATA_PATH.format(version, split)`` gz-json files
    (habitat_audio/dataset.py:97-131)
  - scene graphs: ``AUDIO.META_DIR/{scene}/points.txt + graph.pkl``
    (habitat_audio/utils.py:7-63)
  - audio: ``AUDIO.MONO_DIR`` mono wavs and ``AUDIO.RIR_DIR`` binaural RIRs
    (simulator_train.py:396-415); the unheard-sound presets point MONO_DIR
    at the held-out pool
  - frames: ``SIMULATOR.RENDERED_OBSERVATIONS/{SCENE_DATASET}/{scene}.pkl``
    pre-rendered RGB-D (simulator_train.py:89-95), synthetic frames when
    that directory is absent

Without episode files and scene metadata the trainers and evaluators use
the synthetic micro-scene (env/micro_scene.py)."""

import logging
import os
from typing import List, Optional, Sequence

import numpy as np

from move2hear_tpu_torch.env.audio_db import FileAudioDB
from move2hear_tpu_torch.env.episodes import EpisodeDataset
from move2hear_tpu_torch.env.frame_cache import FileFrameCache, SyntheticFrameCache
from move2hear_tpu_torch.env.micro_scene import MicroSceneBundle
from move2hear_tpu_torch.env.scene import GraphScene

logger = logging.getLogger(__name__)


def resolve_data_path(task_config) -> str:
    """DATA_PATH template -> concrete path (habitat_audio/dataset.py:62-64)."""
    d = task_config.DATASET
    return d.DATA_PATH.format(version=d.VERSION, split=d.SPLIT)


def has_file_backed_data(task_config) -> bool:
    """True when the episode files AND the scene metadata exist on disk."""
    data_path = resolve_data_path(task_config)
    content_dir = os.path.join(os.path.dirname(data_path), "content")
    has_episodes = os.path.isfile(data_path) or (
        os.path.isdir(content_dir)
        and any(f.endswith(".json.gz") for f in os.listdir(content_dir))
    )
    return has_episodes and os.path.isdir(task_config.SIMULATOR.AUDIO.META_DIR)


def bundle_from_config(
    task_config,
    scenes: Optional[Sequence[str]] = None,
    max_rir_length: Optional[int] = None,
) -> MicroSceneBundle:
    """The file-backed bundle the reference's construct_envs would build
    (env_utils.py:531-687): a GraphScene for every scene of the episode
    set, and audio and frame stores shared by scene name.

    scenes: only these scenes (EPS_SCENES, per-worker splits).
    max_rir_length: the RIR length of the device banks; AUDIO.
    RIR_SAMPLING_RATE (1 s of RIR) when not given."""
    sim_cfg = task_config.SIMULATOR
    audio_cfg = sim_cfg.AUDIO

    data_path = resolve_data_path(task_config)
    episodes = EpisodeDataset.from_json_gz(data_path, scenes=scenes)
    if scenes:
        episodes = episodes.filter_by_scenes(list(scenes))
    assert len(episodes) > 0, f"no episodes under {data_path} for {scenes}"

    scene_names = episodes.scene_ids()
    graph_scenes = {
        name: GraphScene.from_files(
            audio_cfg.META_DIR, name, scene_dataset=sim_cfg.SCENE_DATASET,
            graph_file=audio_cfg.GRAPH_FILE, grid_size=sim_cfg.GRID_SIZE,
        )
        for name in scene_names
    }
    audio_db = FileAudioDB(
        mono_dir=audio_cfg.MONO_DIR,
        rir_dir=audio_cfg.RIR_DIR,
        rir_length=max_rir_length or audio_cfg.RIR_SAMPLING_RATE,
        rir_sampling_rate=audio_cfg.RIR_SAMPLING_RATE,
    )
    if sim_cfg.USE_RENDERED_OBSERVATIONS and os.path.isdir(sim_cfg.RENDERED_OBSERVATIONS):
        frame_cache = FileFrameCache(sim_cfg.RENDERED_OBSERVATIONS, sim_cfg.SCENE_DATASET)
    else:
        logger.warning("pre-rendered observations not found at %s; serving synthetic frames",
                       sim_cfg.RENDERED_OBSERVATIONS)
        frame_cache = SyntheticFrameCache()
    logger.info("file-backed bundle: %d episodes over %d scene(s) from %s",
                len(episodes), len(scene_names), data_path)
    return MicroSceneBundle(scene=graph_scenes, audio_db=audio_db,
                            frame_cache=frame_cache, episodes=episodes)


def split_scenes_round_robin(
    scene_names: Sequence[str], num_envs: int, shuffle: bool = False, seed: int = 0,
) -> List[List[str]]:
    """The reference's scene split (env_utils.py:556-567): shuffled for
    train, at least as many scenes as envs, round-robin over the envs."""
    names = list(scene_names)
    if shuffle:
        np.random.default_rng(seed).shuffle(names)
    assert len(names) >= num_envs, (
        f"{len(names)} scenes < {num_envs} env processes; reduce NUM_PROCESSES "
        "(env_utils.py:558)"
    )
    splits: List[List[str]] = [[] for _ in range(num_envs)]
    for idx, name in enumerate(names):
        splits[idx % num_envs].append(name)
    return splits
