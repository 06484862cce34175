"""Pre-rendered RGB/depth observations: maps (scene, node, rotation) ->
{rgb (H, W, 3) uint8, depth (H, W, 1) float32}, drawn procedurally
(``SyntheticFrameCache``) or read from the reference's per-scene pickles
(``FileFrameCache``, simulator_train.py:89-95)."""

import os
import pickle
import zlib
from typing import Dict, Tuple

import numpy as np


class SyntheticFrameCache:
    """A view hash of (scene, node, rotation) seeds smooth gradients so
    different poses look different."""

    def __init__(self, height: int = 128, width: int = 128):
        self._h, self._w = height, width
        self._cache: Dict[Tuple, Dict[str, np.ndarray]] = {}

    def get(self, scene, node, rotation):
        key = (scene, int(node), int(rotation) % 360)
        if key not in self._cache:
            seed = zlib.crc32(repr(key).encode()) & 0xFFFFFFFF
            rng = np.random.default_rng(seed)
            yy, xx = np.mgrid[0 : self._h, 0 : self._w].astype(np.float32)
            base = (
                np.sin(xx / self._w * rng.uniform(2, 9) + rng.uniform(0, 6))
                + np.cos(yy / self._h * rng.uniform(2, 9) + rng.uniform(0, 6))
            ) * 0.25 + 0.5
            rgb = np.stack(
                [base * rng.uniform(0.3, 1.0) for _ in range(3)], axis=-1
            )
            rgb = (np.clip(rgb, 0, 1) * 255).astype(np.uint8)
            depth = np.clip(base, 0, 1)[..., None].astype(np.float32)
            self._cache[key] = {"rgb": rgb, "depth": depth}
        return self._cache[key]


class FileFrameCache:
    """Per-scene pickle files ``{root}/{scene_dataset}/{scene}.pkl`` holding
    {(node, rotation): {'rgb': ..., 'depth': ...}}, loaded on first use and
    kept. A 2-D depth gets a channel axis; rgb keeps 3 channels."""

    def __init__(self, root: str, scene_dataset: str = "mp3d"):
        self._root = root
        self._scene_dataset = scene_dataset
        self._scenes: Dict[str, Dict] = {}

    def _load(self, scene: str):
        if scene not in self._scenes:
            path = os.path.join(self._root, self._scene_dataset, scene + ".pkl")
            with open(path, "rb") as f:
                self._scenes[scene] = pickle.load(f)
        return self._scenes[scene]

    def get(self, scene, node, rotation):
        obs = self._load(scene)[(int(node), int(rotation) % 360)]
        out = {}
        if "rgb" in obs:
            out["rgb"] = np.asarray(obs["rgb"])[..., :3]
        if "depth" in obs:
            d = np.asarray(obs["depth"])
            out["depth"] = d if d.ndim == 3 else d[..., None]
        return out
