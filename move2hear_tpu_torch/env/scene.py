"""Grid-graph scene: navigation nodes, adjacency, movement geometry and
geodesic distances (``habitat_audio/simulator_train.py:59-95,267-353,488-532``).

Coordinate convention is habitat's: +Y up, -Z forward, +X right; angle 0 is
+X. Neighbor directions are ``round(deg(atan2(dz, dx))) % 360``; the device
env (env/device_env.py) and ``forward_neighbor`` (the host simulator,
env/sim.py) apply the movement rule to them: the first adjacency-ordered
neighbor whose direction equals the orientation, or, for a diagonal edge,
differs from it by exactly 45 degrees. Geodesics come from a breadth-first
search.

Both run in Python (``forward_neighbor``, ``bfs``) or, once
``attach_native`` has attached it, in the C++ graph walker
(``native/binding.py``), as the JAX package routes them: every scene that
``from_files`` loads, and every scene of 64 nodes or more that
``build_device_scene`` stacks, takes the walker. The Python versions stay
as the plain ones: grids and micro-scenes below 64 nodes use them, and the
tests hold the walker to them. A walker that fails to build or load
raises.

``GraphScene.from_files`` reads the SoundSpaces layout,
``{META_DIR}/{scene}/points.txt`` and ``graph.pkl``, a pickled
``networkx.Graph``. It unpickles the graph without networkx: networkx's
classes map to small stand-ins that serve ``g[i]`` (adjacency in insertion
order) and ``g.nodes[i]["point"]``; networkx 3.x also pickles cached
``nodes`` / ``adj`` views and a ``__networkx_cache__`` in the graph's
state, which the stand-ins take and ignore. ``write_graph_pickle`` writes
such a file, naming networkx's ``Graph`` class, without networkx.
"""

import os
import pickle
from collections import deque
from typing import Dict, List, Sequence

import numpy as np

CARDINALS = (0, 90, 180, 270)


class _NetworkxGraph:
    """Unpickled stand-in of a networkx graph: ``g[i]`` is node i's
    adjacency dict (insertion order kept), ``g.nodes[i]`` its attribute
    dict."""

    def __setstate__(self, state):
        self._node = state["_node"]
        self._adj = state["_adj"]

    def __getitem__(self, node):
        return self._adj[node]

    @property
    def nodes(self):
        return self._node


class _NetworkxView:
    """Unpickled stand-in of a cached networkx view (NodeView,
    AdjacencyView, ...): kept as its pickled state, never read."""

    def __setstate__(self, state):
        self.state = state


class _GraphUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module == "networkx" or module.startswith("networkx."):
            if name == "Graph":
                return _NetworkxGraph
            if name.endswith("Graph"):
                raise pickle.UnpicklingError(
                    f"graph.pkl holds a networkx {name}; a scene graph is an undirected "
                    "networkx Graph"
                )
            return _NetworkxView
        return super().find_class(module, name)


def load_graph_pickle(path: str):
    """A scene's ``graph.pkl`` as a graph stand-in, without networkx."""
    with open(path, "rb") as f:
        return _GraphUnpickler(f).load()


def write_graph_pickle(path: str, positions, neighbors) -> None:
    """Write ``graph.pkl`` as SoundSpaces ships it: a pickled
    ``networkx.classes.graph.Graph`` (protocol 2) whose nodes carry a
    ``point`` attribute (a list of 3 floats) and whose adjacency keeps the
    order of `neighbors`. networkx is not needed to write it."""
    state = {
        "graph": {},
        "_node": {i: {"point": [float(x) for x in p]} for i, p in enumerate(positions)},
        "_adj": {i: {int(j): {} for j in ns} for i, ns in enumerate(neighbors)},
        "__networkx_cache__": {},
    }
    body = pickle.dumps(state, protocol=2)
    assert body[:2] == b"\x80\x02" and body[-1:] == b"."
    # PROTO 2, GLOBAL networkx.classes.graph.Graph, EMPTY_TUPLE, NEWOBJ, the
    # state dict, BUILD, STOP: the opcodes pickle writes for a Graph
    data = (b"\x80\x02cnetworkx.classes.graph\nGraph\n)\x81" + body[2:-1] + b"b.")
    with open(path, "wb") as f:
        f.write(data)


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
        self._native = None  # the C++ walker, once attach_native() has run

    @property
    def num_nodes(self) -> int:
        return len(self.positions)

    def edge_direction(self, a: int, b: int) -> int:
        p1, p2 = self.positions[a], self.positions[b]
        return int(
            np.around(np.rad2deg(np.arctan2(p2[2] - p1[2], p2[0] - p1[0])))
        ) % 360

    def forward_neighbor(self, node: int, orientation: int) -> int:
        """The first neighbor (adjacency order) matching the facing
        direction; the node itself if none (the agent bumps into a wall)."""
        if self._native is not None:
            return self._native.forward_neighbor(node, orientation)
        for nb in self.neighbors[node]:
            direction = self.edge_direction(node, nb)
            if direction not in CARDINALS:
                if int(abs(direction - orientation)) == 45:
                    return nb
            elif direction == orientation:
                return nb
        return node

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
        if self._native is not None:
            return self._native.shortest_path_steps(a, b)
        if a not in self._dist_cache:
            self._dist_cache[a] = self.bfs(a)
        return int(self._dist_cache[a][b])

    def geodesic_distance(self, a: int, b: int) -> float:
        """steps * GRID_SIZE (simulator_train.py:488-499)."""
        return self.shortest_path_steps(a, b) * self.grid_size

    def euclidean_distance(self, a: int, b: int) -> float:
        pa, pb = self.positions[a], self.positions[b]
        return float(np.hypot(pa[0] - pb[0], pa[2] - pb[2]))

    def attach_native(self):
        """Route movement and geodesics through the C++ graph walker, built
        at first use; raises if it cannot be built or loaded. Returns the
        walker."""
        if self._native is None:
            from move2hear_tpu_torch.native.binding import NativeGraph

            self._native = NativeGraph(self.positions, self.neighbors)
        return self._native

    @classmethod
    def from_files(
        cls,
        meta_dir: str,
        scene: str,
        scene_dataset: str = "mp3d",
        graph_file: str = "graph.pkl",
        grid_size: float = 1.0,
    ) -> "GraphScene":
        """Load points.txt + graph.pkl in the SoundSpaces layout
        (habitat_audio/utils.py:7-63). The graph's ``point`` attributes
        override the transformed points where present. The scene moves and
        measures through the C++ graph walker."""
        parent = os.path.join(meta_dir, scene)
        points_data = np.loadtxt(os.path.join(parent, "points.txt"), delimiter="\t", ndmin=2)
        if scene_dataset == "mp3d":
            pts = np.stack(
                [points_data[:, 1], points_data[:, 3] - 1.5, -points_data[:, 2]], axis=1
            )
        elif scene_dataset == "replica":
            pts = np.stack(
                [points_data[:, 1], points_data[:, 3] - 1.5528907, -points_data[:, 2]], axis=1
            )
        else:
            raise NotImplementedError(scene_dataset)
        graph = load_graph_pickle(os.path.join(parent, graph_file))
        neighbors = [list(graph[i]) for i in range(len(pts))]
        for i in range(len(pts)):
            if "point" in graph.nodes[i]:
                pts[i] = graph.nodes[i]["point"]
        out = cls(scene, pts, neighbors, grid_size=grid_size)
        out.attach_native()
        return out

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
