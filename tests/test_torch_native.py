"""The port's C++ graph walker (``move2hear_tpu_torch/native/``) against the
JAX package's (``move2hear_tpu/native/``) and against the port's Python
path (``GraphScene.bfs`` / ``forward_neighbor``): all-pairs geodesics,
``forward_neighbor`` and ``geodesic_batch`` on a 5x5 grid and on seeded
8-connected graphs with jittered positions, diagonal edges, shuffled
adjacency and isolated nodes; ``from_files`` attaching the walker;
``build_device_scene``'s table at V >= 64; a broken compiler raising; a
forked child leaving the parent's graph intact; and chip_smoke.py's phase
8o small. Every comparison is exact: the copies run the same C++ and the
Python rule agrees with it away from directions of exactly x.5 degrees."""

import multiprocessing as mp
import os
import pickle
import sys
import time

import numpy as np
import pytest
import torch

from move2hear_tpu.env.device_env import build_device_scene as j_build_device_scene
from move2hear_tpu.env.scene import GraphScene as JGraphScene
from move2hear_tpu_torch.env import device_env as de
from move2hear_tpu_torch.env.scene import GraphScene
from move2hear_tpu_torch.native import binding
from move2hear_tpu_torch.native.binding import NativeGraph
from _torch_threads import cap_torch_threads

cap_torch_threads()

ORIENTATIONS = tuple(range(0, 360, 45))


def jittered_graph(rows, cols, jitter, seed):
    """An 8-connected rows x cols lattice with each position moved by up to
    `jitter` (x and z), a quarter of the edges dropped, every adjacency list
    shuffled and the last node cut off."""
    rng = np.random.default_rng(seed)
    v = rows * cols
    pos = np.zeros((v, 3))
    for r in range(rows):
        for c in range(cols):
            pos[r * cols + c] = (c + rng.uniform(-jitter, jitter), rng.uniform(-0.1, 0.1),
                                 r + rng.uniform(-jitter, jitter))
    neighbors = [[] for _ in range(v)]
    for r in range(rows):
        for c in range(cols):
            for dr, dc in ((0, 1), (1, -1), (1, 0), (1, 1)):
                rr, cc = r + dr, c + dc
                a, b = r * cols + c, rr * cols + cc
                if 0 <= rr < rows and 0 <= cc < cols and v - 1 not in (a, b) \
                        and rng.uniform() > 0.25:
                    neighbors[a].append(b)
                    neighbors[b].append(a)
    for ns in neighbors:
        rng.shuffle(ns)
    return pos, neighbors


def make_graph(kind):
    if kind == "grid5":
        g = GraphScene.grid("grid5", 5, 5)
        return g.positions, g.neighbors
    if kind == "lattice-diagonal":  # every direction a multiple of 45 degrees
        return jittered_graph(6, 7, 1e-3, seed=1)
    return jittered_graph(8, 9, 0.2, seed=2)  # directions of any degree


def jax_walker(positions, neighbors):
    """The JAX package's walker; its library is built by make at first use,
    which another test process may be writing: wait for it."""
    from move2hear_tpu.native.binding import NativeGraph as JNativeGraph

    deadline = time.monotonic() + 60
    while True:
        try:
            return JNativeGraph(positions, neighbors)
        except OSError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.5)


@pytest.mark.parametrize("kind", ["grid5", "lattice-diagonal", "jittered"])
def test_walker_matches_jax_walker_and_python_path(kind):
    pos, neighbors = make_graph(kind)
    v = len(pos)
    ours, ref = NativeGraph(pos, neighbors), jax_walker(pos, neighbors)
    py, jpy = GraphScene(kind, pos, neighbors), JGraphScene(kind, pos, neighbors)
    idx = np.arange(v)
    a, b = np.repeat(idx, v), np.tile(idx, v)
    table = ours.geodesic_batch(a, b)
    assert table.dtype == np.int32
    np.testing.assert_array_equal(table, ref.geodesic_batch(a, b))
    np.testing.assert_array_equal(table.reshape(v, v), np.stack([py.bfs(i) for i in range(v)]))
    assert (table == -1).any() == (kind != "grid5")  # the cut-off node is unreachable
    rng = np.random.default_rng(3)
    pairs = rng.integers(0, v, (200, 2))
    np.testing.assert_array_equal(ours.geodesic_batch(pairs[:, 0], pairs[:, 1]),
                                  table.reshape(v, v)[pairs[:, 0], pairs[:, 1]])
    for x, y in pairs[:50]:
        assert ours.shortest_path_steps(int(x), int(y)) == ref.shortest_path_steps(int(x), int(y)) \
            == py.shortest_path_steps(int(x), int(y)) == jpy.shortest_path_steps(int(x), int(y))
    orientations = ORIENTATIONS if kind == "grid5" else range(360)
    moves = diagonal = 0
    for node in range(v):
        for o in orientations:
            got = ours.forward_neighbor(node, o)
            assert got == ref.forward_neighbor(node, o) == py.forward_neighbor(node, o) \
                == jpy.forward_neighbor(node, o), (node, o)
            moves += got != node
            diagonal += got != node and py.edge_direction(node, got) not in (0, 90, 180, 270)
    assert moves > 0 and (diagonal > 0) == (kind != "grid5")


def test_walker_edges_out_of_range_closed_and_unpicklable():
    scene = GraphScene.grid("g", 3, 4)
    walker = scene.attach_native()
    assert scene.attach_native() is walker
    ref = jax_walker(scene.positions, scene.neighbors)
    for a, b in ((-1, 0), (0, 12), (12, 12)):
        assert walker.shortest_path_steps(a, b) == ref.shortest_path_steps(a, b) == -1
    with pytest.raises(IndexError):
        walker.forward_neighbor(12, 0)
    with pytest.raises(IndexError):
        walker.geodesic_batch([0, 1], [2, 12])
    with pytest.raises(ValueError):
        walker.geodesic_batch([0, 1], [2])
    assert walker.geodesic_batch([], []).shape == (0,)
    with pytest.raises(ValueError):
        NativeGraph(scene.positions, [[1], [12]] + scene.neighbors[2:])
    with pytest.raises(TypeError):
        pickle.dumps(scene)  # a scene carrying the walker's handle
    walker.close()
    walker.close()  # freed once
    with pytest.raises(ValueError):
        walker.shortest_path_steps(0, 1)


def test_threads_never_run_in_one_graph_at_once():
    """The BFS rows are cached in the graph without a lock: the binding
    holds the interpreter lock through each call (a PyDLL), so threads that
    fill the same rows at once still read the Python path's table."""
    import threading

    pos, neighbors = jittered_graph(24, 25, 1e-3, seed=6)
    v = len(pos)
    want = np.stack([GraphScene("p", pos, neighbors).bfs(i) for i in range(v)]).ravel()
    idx = np.arange(v)
    a, b = np.repeat(idx, v), np.tile(idx, v)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(3):
            walker, out = NativeGraph(pos, neighbors), {}
            threads = [threading.Thread(target=lambda i=i: out.__setitem__(
                i, walker.geodesic_batch(a, b) if i % 2 else [
                    walker.shortest_path_steps(int(x), int(y)) for x, y in zip(a[::97], b[::97])]))
                for i in range(2 * os.cpu_count())]
            for t in threads:
                t.start()
            for t in threads:
                t.join(60)
            assert not any(t.is_alive() for t in threads) and len(out) == len(threads)
            for i, got in out.items():
                np.testing.assert_array_equal(got, want if i % 2 else want[::97])
    finally:
        sys.setswitchinterval(interval)


def test_from_files_attaches_the_walker(tmp_path):
    from _ref_layout import GRID, write_reference_layout

    opts = write_reference_layout(tmp_path)
    meta = opts["META_DIR"]
    for name in ("sceneA", "sceneB"):
        ours, ref = GraphScene.from_files(meta, name), JGraphScene.from_files(meta, name)
        assert isinstance(ours._native, NativeGraph) and ref._native is not None
        py = GraphScene(name, ours.positions, ours.neighbors)
        assert ours.num_nodes == GRID * GRID
        for a in range(ours.num_nodes):
            for b in range(ours.num_nodes):
                assert ours.shortest_path_steps(a, b) == ref.shortest_path_steps(a, b) \
                    == py.shortest_path_steps(a, b)
            for o in ORIENTATIONS:
                assert ours.forward_neighbor(a, o) == ref.forward_neighbor(a, o) \
                    == py.forward_neighbor(a, o)


@pytest.mark.parametrize("kinds", [("grid", 8, 9), ("jittered", 9, 9)],
                         ids=["grid72", "jittered81"])
def test_build_device_scene_dist_matches_jax_at_64_nodes(kinds):
    kind, rows, cols = kinds
    if kind == "grid":
        big = GraphScene.grid("big", rows, cols)
        pos, neighbors = big.positions, big.neighbors
    else:
        pos, neighbors = jittered_graph(rows, cols, 0.2, seed=4)
    small = GraphScene.grid("small", 7, 9)  # 63 nodes: the Python BFS
    ours = {"big": GraphScene("big", pos, neighbors), "small": small}
    ref = {"big": JGraphScene("big", pos, neighbors), "small": JGraphScene.grid("small", 7, 9)}
    dev = de.build_device_scene(ours, "cpu")
    jdev = j_build_device_scene(ref)
    assert ours["big"]._native is not None and ref["big"]._native is not None
    assert small._native is None and ref["small"]._native is None
    assert dev.dist.dtype == torch.int64
    np.testing.assert_array_equal(dev.dist.numpy(), np.asarray(jdev.dist))
    v = len(pos)
    plain = np.stack([GraphScene("p", pos, neighbors).bfs(i) for i in range(v)])
    np.testing.assert_array_equal(dev.dist[0, :v, :v].numpy(), plain)
    assert (dev.dist.numpy() == -1).any() and dev.dist.min() == -1
    np.testing.assert_array_equal(dev.neighbors.numpy(), np.asarray(jdev.neighbors))
    np.testing.assert_array_equal(dev.edge_dirs.numpy(), np.asarray(jdev.edge_dirs))


@pytest.mark.parametrize("cxx", ["false", "sh -c 'echo this-compiler-is-broken >&2; exit 3' sh",
                                 "/nonexistent/c++"], ids=["false", "stderr", "missing"])
def test_a_broken_compiler_raises_and_nothing_falls_back(cxx, monkeypatch, tmp_path):
    from move2hear_tpu_torch.env.layout import write_scene_graph

    write_scene_graph(str(tmp_path), GraphScene.grid("s", 3, 3))
    good = binding.library_path()
    monkeypatch.setenv("CXX", cxx)
    assert binding.library_path() != good  # never the library of another compiler
    with pytest.raises(RuntimeError, match="native graph walker") as err:
        GraphScene.grid("g", 3, 3).attach_native()
    if "stderr" in cxx:
        assert "this-compiler-is-broken" in str(err.value)
    with pytest.raises(RuntimeError):
        GraphScene.from_files(str(tmp_path), "s")
    with pytest.raises(RuntimeError):
        de.build_device_scene({"g": GraphScene.grid("g", 8, 8)}, "cpu")
    assert not os.path.exists(binding.library_path())


class _Recorder:
    """The walker's library, recording the names of the functions called."""

    def __init__(self, lib):
        self.lib, self.calls = lib, set()

    def __getattr__(self, name):
        self.calls.add(name)
        return getattr(self.lib, name)


def _child(conn, scene, how):
    walker = scene._native
    walker._lib = _Recorder(walker._lib)
    answers = [scene.forward_neighbor(n, o) for n in range(scene.num_nodes)
               for o in ORIENTATIONS] + [scene.shortest_path_steps(a, b)
                                         for a in range(scene.num_nodes)
                                         for b in range(scene.num_nodes)]
    if how == "close":
        walker.close()
        del scene._native
    conn.send((answers, sorted(walker._lib.calls)))
    conn.close()
    if how == "close":
        sys.exit(0)
    os._exit(0)  # as the host env workers leave


@pytest.mark.parametrize("how", ["close", "os_exit"])
def test_a_forked_child_leaves_the_parents_graph_intact(how):
    pos, neighbors = jittered_graph(6, 7, 1e-3, seed=5)
    scene, py = GraphScene("s", pos, neighbors), GraphScene("s", pos, neighbors)
    walker = scene.attach_native()
    scene.shortest_path_steps(0, 1)  # a row cached before the fork
    want = [py.forward_neighbor(n, o) for n in range(py.num_nodes) for o in ORIENTATIONS] + [
        py.shortest_path_steps(a, b) for a in range(py.num_nodes) for b in range(py.num_nodes)]
    ctx = mp.get_context("fork")
    parent, child = ctx.Pipe()
    proc = ctx.Process(target=_child, args=(child, scene, how))
    proc.start()
    child.close()
    assert parent.poll(60)
    got, calls = parent.recv()
    proc.join(60)
    assert not proc.is_alive() and proc.exitcode == 0
    assert got == want
    # the child walked its copy of the graph and never freed it
    assert calls == ["m2h_forward_neighbor", "m2h_shortest_path_steps"]
    assert scene._native is walker and walker._handle is not None
    v = scene.num_nodes
    idx = np.arange(v)
    np.testing.assert_array_equal(walker.geodesic_batch(np.repeat(idx, v), np.tile(idx, v)),
                                  np.asarray(want[v * len(ORIENTATIONS):]))


def test_chip_smoke_graph_phase_runs_on_the_cpu(tmp_path, capsys, monkeypatch):
    import chip_smoke
    from move2hear_tpu_torch.ops import build

    # phase 2 removes the walker's library and builds it anew: here in a
    # directory of the test's own, as other test processes load the shared one
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "_build"))
    built = chip_smoke.walker_build()
    assert binding.library_path().startswith(str(tmp_path)) and built[2] > 0
    chip_smoke.graph_phase(torch, "cpu", str(tmp_path), built, device="cpu",
                           fixture=dict(num_scenes=2, rows=8, cols=9, episodes=3))
    out = capsys.readouterr().out
    assert "2 scenes of V = 72 written" in out and "walker built by" in out
    assert "dist (2, 72, 72) and every other table equal" in out
    assert "6 far-target episodes equal" in out and "walker against Python" in out
