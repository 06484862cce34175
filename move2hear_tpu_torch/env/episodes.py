"""Episode specifications and datasets (``habitat_audio/dataset.py``): an
episode fixes the scene, start node and rotation, per-source (node, sound
name), target class and the start->target geodesic. ``EpisodeDataset.
from_json_gz`` reads the reference's gz-json layout ({data_path}, and
{dirname(data_path)}/content/{scene}.json.gz, each an {'episodes': [...]}
dict); ``generate_episodes`` draws them for fixture scenes."""

import gzip
import json
import os
from dataclasses import dataclass, field
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
    info: Dict = field(default_factory=dict)


class EpisodeDataset:
    def __init__(self, episodes: Sequence[Episode]):
        self.episodes = list(episodes)

    def __len__(self):
        return len(self.episodes)

    def scene_ids(self) -> List[str]:
        """The scenes of the episodes, in order of first appearance."""
        return list(dict.fromkeys(e.scene_id for e in self.episodes))

    def split_for_rank(self, rank: int, world: int) -> "EpisodeDataset":
        return EpisodeDataset(self.episodes[rank::world])

    @staticmethod
    def get_scenes_to_load(data_path: str) -> List[str]:
        """The per-scene episode files of the content dir (dataset.py:56-95)."""
        content_dir = os.path.join(os.path.dirname(data_path), "content")
        if not os.path.isdir(content_dir):
            return []
        return sorted(
            f[: -len(".json.gz")] for f in os.listdir(content_dir) if f.endswith(".json.gz")
        )

    @classmethod
    def from_json_gz(cls, data_path: str, scenes: Optional[Sequence[str]] = None):
        """The reference's gz-json episodes (dataset.py:97-131): the file at
        `data_path` if there is one, then each scene's file of the content
        dir (`scenes`, or all of them)."""
        episodes: List[Episode] = []

        def load_file(path):
            with gzip.open(path, "rt") as f:
                payload = json.load(f)
            for ep in payload.get("episodes", []):
                infos = ep.get("info", [])
                episodes.append(Episode(
                    episode_id=str(ep["episode_id"]),
                    scene_id=os.path.splitext(os.path.basename(ep["scene_id"]))[0],
                    start_node=int(ep.get("start_node", ep.get("start_position_index", 0))),
                    start_rotation=int(ep.get("start_rotation_angle", 0)),
                    source_nodes=[int(g.get("node", g.get("position_index", 0)))
                                  for g in ep.get("goals", [])],
                    sound_names=[i.get("sound") for i in infos],
                    target_class=int(infos[0]["target_label"]) if infos else 0,
                    geodesic_distance=(float(infos[0].get("geodesic_distance", 0.0))
                                       if infos else 0.0),
                    info={"raw": ep},
                ))

        if os.path.isfile(data_path):
            load_file(data_path)
        content_dir = os.path.join(os.path.dirname(data_path), "content")
        if os.path.isdir(content_dir):
            for scene in scenes or cls.get_scenes_to_load(data_path):
                p = os.path.join(content_dir, scene + ".json.gz")
                if os.path.exists(p):
                    load_file(p)
        return cls(episodes)

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
