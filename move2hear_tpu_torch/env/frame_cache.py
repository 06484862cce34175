"""Procedural pre-rendered RGB/depth observations: maps (scene, node,
rotation) -> {rgb (H, W, 3) uint8, depth (H, W, 1) float32}."""

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
