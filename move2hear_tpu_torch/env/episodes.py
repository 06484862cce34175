"""Episode specifications and datasets (``habitat_audio/dataset.py``): an
episode fixes the scene, start node and rotation, per-source (node, sound
name), target class and the start->target geodesic; ``generate_episodes``
draws them for fixture scenes."""

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from move2hear_tpu_torch.env.scene import GraphScene

# class vocabulary of the passive dataset (pretrain/datasets/dataset.py:13-17):
# 10 VoxCeleb speakers + music + esc, esc never a target
CLASS_NAMES_TO_LABELS = {
    "id10393": 0, "id10583": 1, "id10061": 2, "id10954": 3, "id10355": 4,
    "id10799": 5, "id10203": 6, "id10371": 7, "id10361": 8, "id10254": 9,
    "music": 10, "esc": 11,
}
ESC_LABEL = 11
NUM_CLASSES = len(CLASS_NAMES_TO_LABELS)


@dataclass
class Episode:
    episode_id: str
    scene_id: str
    start_node: int
    start_rotation: int                 # degrees, multiple of 90
    source_nodes: List[int]             # target first
    sound_names: List[str]
    target_class: int
    geodesic_distance: float = 0.0      # start -> target source
    all_geodesic_distances: Optional[List[float]] = None


class EpisodeDataset:
    def __init__(self, episodes: Sequence[Episode]):
        self.episodes = list(episodes)

    def __len__(self):
        return len(self.episodes)

    def filter_by_scenes(self, scenes: Sequence[str]) -> "EpisodeDataset":
        return EpisodeDataset([e for e in self.episodes if e.scene_id in scenes])

    def filter_by_scenes_n_ids(self, scenes_n_ids: Dict[str, Sequence[str]]):
        return EpisodeDataset(
            [
                e
                for e in self.episodes
                if e.scene_id in scenes_n_ids
                and e.episode_id in set(map(str, scenes_n_ids[e.scene_id]))
            ]
        )


def generate_episodes(
    scene: GraphScene,
    sound_names: Sequence[str],
    num_episodes: int,
    num_sources: int = 2,
    near_target: bool = True,
    seed: int = 0,
    esc_sounds: Sequence[str] = (),
) -> EpisodeDataset:
    """near_target: the agent starts at the target node ("quality
    improvement"); otherwise >= 2 steps away ("nav")."""
    rng = np.random.default_rng(seed)
    sounds = list(sound_names)
    episodes = []
    for i in range(num_episodes):
        srcs = rng.choice(scene.num_nodes, size=num_sources, replace=False)
        picked = rng.choice(len(sounds), size=num_sources, replace=False)
        names = [sounds[j] for j in picked]
        while names[0] in esc_sounds:
            picked = rng.choice(len(sounds), size=num_sources, replace=False)
            names = [sounds[j] for j in picked]
        if near_target:
            start = int(srcs[0])
        else:
            candidates = [
                n
                for n in range(scene.num_nodes)
                if scene.shortest_path_steps(n, int(srcs[0])) >= 2
            ]
            start = int(rng.choice(candidates)) if candidates else int(srcs[0])
        target_class = int(picked[0]) % NUM_CLASSES
        if target_class == ESC_LABEL:
            target_class = 0
        episodes.append(
            Episode(
                episode_id=str(i),
                scene_id=scene.name,
                start_node=start,
                start_rotation=int(rng.choice([0, 90, 180, 270])),
                source_nodes=[int(s) for s in srcs],
                sound_names=names,
                target_class=target_class,
                geodesic_distance=scene.geodesic_distance(start, int(srcs[0])),
            )
        )
    return EpisodeDataset(episodes)
