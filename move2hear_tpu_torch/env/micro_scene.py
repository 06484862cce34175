"""Synthetic micro-scene: a small grid scene + procedural audio DB + frame
cache + generated episodes, the data source of the device evaluator when
no file-backed Matterport3D/SoundSpaces data is configured."""

from dataclasses import dataclass
from typing import Dict, Union

from move2hear_tpu_torch.env.audio_db import SyntheticAudioDB
from move2hear_tpu_torch.env.episodes import EpisodeDataset, generate_episodes
from move2hear_tpu_torch.env.frame_cache import SyntheticFrameCache
from move2hear_tpu_torch.env.scene import GraphScene

DEFAULT_SOUNDS = [f"class{i}" for i in range(10)] + ["music", "esc"]


@dataclass
class MicroSceneBundle:
    """Scene graph(s) + audio DB + frame cache + episodes."""

    scene: Union[GraphScene, Dict[str, GraphScene]]
    audio_db: SyntheticAudioDB
    frame_cache: SyntheticFrameCache
    episodes: EpisodeDataset

    @property
    def scenes(self) -> Dict[str, GraphScene]:
        if isinstance(self.scene, GraphScene):
            return {self.scene.name: self.scene}
        return self.scene


def build_micro_scene(
    rows: int = 4,
    cols: int = 4,
    num_episodes: int = 16,
    near_target: bool = True,
    rir_length: int = 1000,
    wav_length: int = 16000,
    image_size: int = 128,
    seed: int = 0,
    name: str = "micro",
    unheard_sounds: bool = False,
) -> MicroSceneBundle:
    """unheard_sounds: a disjoint procedural sound pool (same classes,
    different waveforms), the analog of the unheard-sound eval splits."""
    scene = GraphScene.grid(name, rows, cols)
    audio_db = SyntheticAudioDB(
        DEFAULT_SOUNDS,
        wav_length=wav_length,
        rir_length=rir_length,
        seed=seed + (10_000 if unheard_sounds else 0),
    )
    frame_cache = SyntheticFrameCache(image_size, image_size)
    episodes = generate_episodes(
        scene,
        DEFAULT_SOUNDS,
        num_episodes,
        near_target=near_target,
        seed=seed,
        esc_sounds=("esc",),
    )
    return MicroSceneBundle(scene, audio_db, frame_cache, episodes)
