"""The port's file-backed loaders against the JAX package's on one fixture
in the SoundSpaces / reference on-disk layout (2 grid scenes of V = 12,
RIR length 400, written by ``move2hear_tpu_torch/env/layout.py``): scene
graphs (``GraphScene.from_files``), the audio store (``FileAudioDB``), the
frame cache, the episode json.gz, the config-built bundle with its scene
split, and the passive pretrain source. Every loader reads the same files
into the same numbers: the comparisons are exact (the two packages run the
same numpy on them). The graph pickles load without networkx: a real
networkx 3.x pickle, with its cached ``nodes`` and ``adj`` views, with
networkx hidden from ``sys.modules``, and the pickles the port writes load
as a ``networkx.Graph`` here."""

import os
import pickle
import sys

import numpy as np
import pytest

from move2hear_tpu.config import get_config as j_get_config
from move2hear_tpu.env import bundle as jb
from move2hear_tpu.env.audio_db import FileAudioDB as JFileAudioDB
from move2hear_tpu.env.episodes import EpisodeDataset as JEpisodeDataset
from move2hear_tpu.env.frame_cache import FileFrameCache as JFileFrameCache
from move2hear_tpu.env.scene import GraphScene as JGraphScene
from move2hear_tpu.pretrain.dataset import FilePassiveSource as JFilePassiveSource
from move2hear_tpu_torch.config import get_config
from move2hear_tpu_torch.env import bundle as tb
from move2hear_tpu_torch.env.audio_db import FileAudioDB
from move2hear_tpu_torch.env.episodes import EpisodeDataset
from move2hear_tpu_torch.env.frame_cache import FileFrameCache, SyntheticFrameCache
from move2hear_tpu_torch.env.layout import write_soundspaces_layout
from move2hear_tpu_torch.env.scene import GraphScene, load_graph_pickle, write_graph_pickle
from move2hear_tpu_torch.pretrain.dataset import FilePassiveSource
from _torch_threads import cap_torch_threads

cap_torch_threads()

EXP = "configs/test/nearTarget.yaml"
SPLITS = {"test_nearTarget": True, "test_farTarget": False}


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    root = tmp_path_factory.mktemp("layout")
    lay = write_soundspaces_layout(root, num_scenes=2, rows=3, cols=4, episodes_per_scene=3,
                                   rir_length=400, splits=SPLITS, passive_datapoints=4, seed=3)
    return str(root), lay


def _opt(lay, key):
    return lay["opts"][lay["opts"].index(key) + 1]


def _hide_networkx(monkeypatch):
    for name in [m for m in sys.modules if m == "networkx" or m.startswith("networkx.")]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "networkx", None)  # import networkx raises


@pytest.mark.parametrize("scene", ["scene00", "scene01"])
def test_graph_scene_from_files_matches_jax(layout, scene):
    _, lay = layout
    meta = _opt(lay, "TASK_CONFIG.SIMULATOR.AUDIO.META_DIR")
    ours, ref = GraphScene.from_files(meta, scene), JGraphScene.from_files(meta, scene)
    np.testing.assert_array_equal(ours.positions, ref.positions)
    assert ours.neighbors == ref.neighbors
    grid = GraphScene.grid(scene, 3, 4)
    np.testing.assert_array_equal(ours.positions, grid.positions)
    assert ours.neighbors == grid.neighbors  # adjacency order kept through graph.pkl
    for a in range(ours.num_nodes):
        for b in range(ours.num_nodes):
            assert ours.shortest_path_steps(a, b) == ref.shortest_path_steps(a, b)
            assert ours.euclidean_distance(a, b) == ref.euclidean_distance(a, b)
        for orientation in (0, 90, 180, 270):
            assert ours.forward_neighbor(a, orientation) == ref.forward_neighbor(a, orientation)


def test_real_networkx_pickle_loads_with_networkx_hidden(tmp_path, monkeypatch):
    """A networkx.Graph pickled after its cached views were built (networkx
    3.x keeps ``nodes``, ``adj`` and ``__networkx_cache__`` in the pickled
    state); edges of node 0 inserted as [3, 1, 2] pin the adjacency order."""
    import networkx as nx

    g = nx.Graph()
    points = [(0.0, 0.0, 0.0), (1.0, 0.0, 0.0), (0.0, 0.0, 1.0), (2.0, 0.0, 0.0)]
    for i, p in enumerate(points):
        g.add_node(i, point=np.asarray(p))
    for a, b in ((0, 3), (0, 1), (1, 3), (0, 2)):
        g.add_edge(a, b)
    _ = g.nodes, g.adj, g[0]
    state = g.__dict__
    assert {"nodes", "adj", "__networkx_cache__"} <= set(state)
    meta = tmp_path / "meta" / "sceneB"
    os.makedirs(meta)
    with open(meta / "graph.pkl", "wb") as f:
        pickle.dump(g, f)
    np.savetxt(meta / "points.txt", np.array([[i, 9.0 + i, 9.0, 10.5] for i in range(4)]),
               delimiter="\t")
    ref = JGraphScene.from_files(str(tmp_path / "meta"), "sceneB")

    _hide_networkx(monkeypatch)
    with pytest.raises(ImportError):
        with open(meta / "graph.pkl", "rb") as f:
            pickle.load(f)
    scene = GraphScene.from_files(str(tmp_path / "meta"), "sceneB")
    assert scene.neighbors[0] == [3, 1, 2] == ref.neighbors[0]
    assert scene.neighbors == ref.neighbors
    np.testing.assert_array_equal(scene.positions, np.asarray(points))
    np.testing.assert_array_equal(scene.positions, ref.positions)
    assert scene.shortest_path_steps(2, 3) == 2
    assert (scene.edge_direction(0, 1), scene.edge_direction(0, 2)) == (0, 90)


def test_written_graph_pickle_is_a_networkx_graph(layout):
    """The graph.pkl bytes the port writes (chip_smoke.py's fixture) load as
    a networkx.Graph here, with networkx's own API."""
    import networkx as nx

    _, lay = layout
    path = os.path.join(_opt(lay, "TASK_CONFIG.SIMULATOR.AUDIO.META_DIR"), "scene00", "graph.pkl")
    with open(path, "rb") as f:
        g = pickle.load(f)
    grid = GraphScene.grid("g", 3, 4)
    assert type(g) is nx.Graph and g.number_of_nodes() == 12 and g.number_of_edges() == 17
    assert [list(g[i]) for i in range(12)] == grid.neighbors
    np.testing.assert_array_equal([g.nodes[i]["point"] for i in range(12)], grid.positions)
    assert nx.shortest_path_length(g, 0, 11) == grid.shortest_path_steps(0, 11) == 5
    write_graph_pickle(path + ".again", grid.positions, grid.neighbors)
    with open(path, "rb") as f, open(path + ".again", "rb") as f2:
        assert f.read() == f2.read()
    assert [list(load_graph_pickle(path)[i]) for i in range(12)] == grid.neighbors


def test_file_audio_db_matches_jax_and_reads_missing_rirs_as_zeros(layout):
    _, lay = layout
    mono = _opt(lay, "TASK_CONFIG.SIMULATOR.AUDIO.MONO_DIR")
    rirs = _opt(lay, "TASK_CONFIG.SIMULATOR.AUDIO.RIR_DIR")
    ours, ref = FileAudioDB(mono, rirs, rir_length=500), JFileAudioDB(mono, rirs, rir_length=500)
    assert ours.sound_names() == ref.sound_names() and len(ours.sound_names()) == 12
    np.testing.assert_array_equal(ours.mono_bank(), ref.mono_bank())
    for name in ours.sound_names()[:3]:
        assert ours.sound_id(name) == ref.sound_id(name)
        np.testing.assert_array_equal(ours.get_mono(name), ref.get_mono(name))
    for key in (("scene00", 0, 0, 0), ("scene00", 90, 3, 7), ("scene01", 270, 11, 2)):
        got = ours.get_rir(*key)
        np.testing.assert_array_equal(got, ref.get_rir(*key))
        assert got.shape == (500, 2) and (got[400:] == 0).all() and np.abs(got).max() == 1.0
    np.testing.assert_array_equal(ours.get_rir_block("scene01", 180, 5, 12),
                                  ref.get_rir_block("scene01", 180, 5, 12))
    # a missing and an unreadable RIR file read as zeros (simulator_train.py:407-415)
    bad = os.path.join(rirs, "scene01", "0", "4_5.wav")
    with open(bad, "wb") as f:
        f.write(b"not a wav")
    for key in (("scene00", 0, 99, 1), ("scene01", 0, 4, 5)):
        assert (ours.get_rir(*key) == 0).all() and ours.get_rir(*key).shape == (500, 2)
        np.testing.assert_array_equal(ours.get_rir(*key), ref.get_rir(*key))


def test_file_frame_cache_matches_jax(layout, tmp_path):
    _, lay = layout
    root = _opt(lay, "TASK_CONFIG.SIMULATOR.RENDERED_OBSERVATIONS")
    ours, ref = FileFrameCache(root), JFileFrameCache(root)
    for scene, node, rot in (("scene00", 0, 0), ("scene01", 11, 270), ("scene00", 5, 450)):
        a, b = ours.get(scene, node, rot), ref.get(scene, node, rot)
        assert sorted(a) == sorted(b) == ["depth", "rgb"]
        assert a["rgb"].shape == (128, 128, 3) and a["depth"].shape == (128, 128, 1)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("split", sorted(SPLITS))
def test_episodes_from_json_gz_match_jax(layout, split):
    root, _ = layout
    data_path = os.path.join(root, "datasets", "audio_separation", "v1", split, split + ".json.gz")
    assert EpisodeDataset.get_scenes_to_load(data_path) == \
        JEpisodeDataset.get_scenes_to_load(data_path) == ["scene00", "scene01"]
    ours, ref = EpisodeDataset.from_json_gz(data_path), JEpisodeDataset.from_json_gz(data_path)
    assert len(ours) == len(ref) == 6
    for a, b in zip(ours.episodes, ref.episodes):
        for f in ("episode_id", "scene_id", "start_node", "start_rotation", "source_nodes",
                  "sound_names", "target_class", "geodesic_distance", "info"):
            assert getattr(a, f) == getattr(b, f), f
        assert (a.start_node == a.source_nodes[0]) == SPLITS[split]
    assert ours.scene_ids() == ref.scene_ids() == ["scene00", "scene01"]
    for rank in range(2):
        assert [e.episode_id for e in ours.split_for_rank(rank, 2).episodes] == \
            [e.episode_id for e in ref.split_for_rank(rank, 2).episodes]
    only = EpisodeDataset.from_json_gz(data_path, scenes=["scene01"])
    assert {e.scene_id for e in only.episodes} == {"scene01"} and len(only) == 3


def test_bundle_from_config_matches_jax(layout, tmp_path):
    _, lay = layout
    cfg = get_config(EXP, lay["opts"], str(tmp_path), "eval")
    j_cfg = j_get_config(EXP, lay["opts"], str(tmp_path), "eval")
    assert tb.resolve_data_path(cfg.TASK_CONFIG) == jb.resolve_data_path(j_cfg.TASK_CONFIG)
    assert tb.has_file_backed_data(cfg.TASK_CONFIG) and jb.has_file_backed_data(j_cfg.TASK_CONFIG)
    ours = tb.bundle_from_config(cfg.TASK_CONFIG, max_rir_length=400)
    ref = jb.bundle_from_config(j_cfg.TASK_CONFIG, max_rir_length=400)
    assert sorted(ours.scenes) == sorted(ref.scenes) == ["scene00", "scene01"]
    for name in ours.scenes:
        assert ours.scenes[name].neighbors == ref.scenes[name].neighbors
    assert [e.episode_id for e in ours.episodes.episodes] == [e.episode_id for e in ref.episodes.episodes]
    assert isinstance(ours.audio_db, FileAudioDB) and isinstance(ours.frame_cache, FileFrameCache)
    np.testing.assert_array_equal(ours.audio_db.get_rir("scene01", 90, 1, 2),
                                  ref.audio_db.get_rir("scene01", 90, 1, 2))
    sub = ours.for_scenes(["scene01"])
    assert list(sub.scenes) == ["scene01"] and len(sub.episodes) == 3
    assert sub.single_scene.name == "scene01"

    # EPS_SCENES-style restriction, and synthetic frames without the pickles
    opts = lay["opts"] + ["TASK_CONFIG.SIMULATOR.RENDERED_OBSERVATIONS", str(tmp_path / "none")]
    cfg2 = get_config(EXP, opts, str(tmp_path), "eval")
    only = tb.bundle_from_config(cfg2.TASK_CONFIG, scenes=["scene00"])
    assert list(only.scenes) == ["scene00"] and isinstance(only.frame_cache, SyntheticFrameCache)
    assert only.audio_db.rir_length == 16000  # AUDIO.RIR_SAMPLING_RATE when not given
    cfg3 = get_config(EXP, lay["opts"][:-2] + ["TASK_CONFIG.DATASET.DATA_PATH",
                                              str(tmp_path / "{split}.json.gz")],
                      str(tmp_path), "eval")
    assert not tb.has_file_backed_data(cfg3.TASK_CONFIG)


@pytest.mark.parametrize("shuffle", [False, True])
def test_split_scenes_round_robin_matches_jax(shuffle):
    names = [f"s{i}" for i in range(7)]
    for n in (1, 3, 7):
        assert tb.split_scenes_round_robin(names, n, shuffle, seed=5) == \
            jb.split_scenes_round_robin(names, n, shuffle, seed=5)
    with pytest.raises(AssertionError, match="reduce NUM_PROCESSES"):
        tb.split_scenes_round_robin(names, 8, shuffle)


@pytest.mark.parametrize("split", ["train", "val"])
def test_file_passive_source_batches_match_jax(layout, split):
    root, lay = layout
    audio = _opt(lay, "TASK_CONFIG.SIMULATOR.AUDIO.PASSIVE_TRAIN_AUDIO_DIR")
    rirs = _opt(lay, "TASK_CONFIG.SIMULATOR.AUDIO.RIR_DIR")
    dp = os.path.join(root, "passive_datasets", "v1", split)
    args = (dp, rirs, audio, ["scene00", "scene01"])
    ours = FilePassiveSource(*args, rir_length=450, max_datapoints_per_scene=3)
    ref = JFilePassiveSource(*args, rir_length=450, max_datapoints_per_scene=3)
    assert len(ours) == len(ref) == 6
    for deterministic, start in ((False, 0), (True, 0), (True, 4)):
        a = ours.sample_batch(np.random.default_rng(7), 5, deterministic, start)
        b = ref.sample_batch(np.random.default_rng(7), 5, deterministic, start)
        for k in ("mono_wavs", "rirs", "target_class"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert (a["target_class"] != 11).all() and (a["rirs"][:, :, 400:] == 0).all()
    # a datapoint whose RIR file is gone reads zeros for that source
    gone = ours._datapoints[0][1]
    os.rename(gone, gone + ".bak")
    try:
        fresh = FilePassiveSource(*args, rir_length=450, max_datapoints_per_scene=3)
        batch = fresh.sample_batch(np.random.default_rng(0), 3, deterministic=True)
        assert (batch["rirs"][0, 1] == 0).all() and np.abs(batch["rirs"][0, 0]).max() > 0
    finally:
        os.rename(gone + ".bak", gone)
