"""Grid-graph scene: navigation nodes, adjacency, movement geometry and
geodesic distances (``habitat_audio/simulator_train.py:59-95,267-353,488-532``).

Coordinate convention is habitat's: +Y up, -Z forward, +X right; angle 0 is
+X. Neighbor directions are ``round(deg(atan2(dz, dx))) % 360``; the device
env (env/device_env.py) applies the movement rule to them. Geodesics come
from a breadth-first search in Python.
"""

from collections import deque
from typing import Dict, List, Sequence

import numpy as np

class GraphScene:
    def __init__(
        self,
        name: str,
        positions: np.ndarray,            # (N, 3)
        neighbors: Sequence[Sequence[int]],
        grid_size: float = 1.0,
    ):
        self.name = name
        self.positions = np.asarray(positions, np.float64)
        self.neighbors = [list(ns) for ns in neighbors]
        self.grid_size = grid_size
        self._dist_cache: Dict[int, np.ndarray] = {}

    @property
    def num_nodes(self) -> int:
        return len(self.positions)

    def edge_direction(self, a: int, b: int) -> int:
        p1, p2 = self.positions[a], self.positions[b]
        return int(
            np.around(np.rad2deg(np.arctan2(p2[2] - p1[2], p2[0] - p1[0])))
        ) % 360

    def bfs(self, src: int) -> np.ndarray:
        """Steps from `src` to every node, -1 where unreachable."""
        dist = np.full(self.num_nodes, -1, np.int32)
        dist[src] = 0
        q = deque([src])
        while q:
            u = q.popleft()
            for v in self.neighbors[u]:
                if dist[v] < 0:
                    dist[v] = dist[u] + 1
                    q.append(v)
        return dist

    def shortest_path_steps(self, a: int, b: int) -> int:
        if a not in self._dist_cache:
            self._dist_cache[a] = self.bfs(a)
        return int(self._dist_cache[a][b])

    def geodesic_distance(self, a: int, b: int) -> float:
        """steps * GRID_SIZE (simulator_train.py:488-499)."""
        return self.shortest_path_steps(a, b) * self.grid_size

    @classmethod
    def grid(
        cls,
        name: str,
        rows: int,
        cols: int,
        grid_size: float = 1.0,
    ) -> "GraphScene":
        """Synthetic rows x cols 4-connected grid. Node id = r * cols + c,
        x = c * grid_size, z = r * grid_size."""
        positions = np.zeros((rows * cols, 3))
        neighbors: List[List[int]] = []
        for r in range(rows):
            for c in range(cols):
                positions[r * cols + c] = (c * grid_size, 0.0, r * grid_size)
        for r in range(rows):
            for c in range(cols):
                ns = []
                for dr, dc in ((0, 1), (0, -1), (1, 0), (-1, 0)):
                    rr, cc = r + dr, c + dc
                    if 0 <= rr < rows and 0 <= cc < cols:
                        ns.append(rr * cols + cc)
                neighbors.append(ns)
        return cls(name, positions, neighbors, grid_size=grid_size)
