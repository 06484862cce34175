"""Write a synthetic dataset in the SoundSpaces / reference on-disk layout,
so that the file-backed loaders (``env/bundle.py``, the pretrain's
``FilePassiveSource``) run from config paths alone:

  {root}/metadata/mp3d/{scene}/points.txt + graph.pkl    habitat_audio/utils.py:7-63
  {root}/binaural_rirs/mp3d/{scene}/{az}/{r}_{s}.wav     simulator_train.py:402-415
  {root}/audio_data/{train,val}/{class}_{i}.wav          datasets/dataset.py:48-64
  {root}/scene_observations/mp3d/{scene}.pkl             simulator_train.py:89-95
  {root}/datasets/audio_separation/v1/{split}/content/{scene}.json.gz
                                                         habitat_audio/dataset.py:97-131
  {root}/passive_datasets/v1/{train,val}/{scene}.pkl     datasets/dataset.py:73-77

Scenes are rows x cols grids (``GraphScene.grid``); graph.pkl names
networkx's Graph class, written without networkx. RIRs are 16-bit stereo
wavs of ``rir_length`` samples: a direct path and a few reflections of
unit integer amplitude (the loaders read the samples as floats, unscaled),
the direct path delayed by the graph distance and each ear by the azimuth.
Mono sounds are 16-bit, one per class and pool. Everything is drawn from
``seed``.
"""

import gzip
import json
import os
import pickle
from typing import Dict, List

import numpy as np

from move2hear_tpu_torch.env.episodes import CLASS_NAMES_TO_LABELS, ESC_LABEL
from move2hear_tpu_torch.env.scene import GraphScene, write_graph_pickle

AZIMUTHS = (0, 90, 180, 270)


def _write_wav(path: str, data: np.ndarray, sr: int = 16000) -> int:
    from scipy.io import wavfile

    os.makedirs(os.path.dirname(path), exist_ok=True)
    wavfile.write(path, sr, data)
    return os.path.getsize(path)


def _rir(rng, dist: int, azimuth: int, rir_length: int) -> np.ndarray:
    rir = np.zeros((rir_length, 2), np.int16)
    delay = min(rir_length - 1, 8 + 24 * dist)
    itd = int(round(6 * np.sin(np.deg2rad(azimuth))))  # interaural delay, samples
    for ear, shift in ((0, max(0, itd)), (1, max(0, -itd))):
        rir[min(rir_length - 1, delay + shift), ear] = 1
        for tap in rng.integers(delay + 16, rir_length, int(rng.integers(1, 4))):
            rir[tap, ear] = rng.choice([-1, 1])
    return rir


def write_scene_graph(meta_dir: str, scene: GraphScene) -> int:
    """Write `scene`'s ``points.txt`` and ``graph.pkl`` under
    ``{meta_dir}/{scene.name}/`` as SoundSpaces ships them. Returns the
    bytes written."""
    meta = os.path.join(meta_dir, scene.name)
    os.makedirs(meta, exist_ok=True)
    # points.txt holds (index, x, y, z) before the mp3d transform
    # (utils.py:23-27), which maps them to (x, z - 1.5, -y)
    lines = [f"{i}\t{p[0]}\t{-p[2]}\t{p[1] + 1.5}" for i, p in enumerate(scene.positions)]
    with open(os.path.join(meta, "points.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    write_graph_pickle(os.path.join(meta, "graph.pkl"), scene.positions, scene.neighbors)
    return sum(os.path.getsize(os.path.join(meta, f)) for f in ("points.txt", "graph.pkl"))


def write_soundspaces_layout(
    root: str,
    num_scenes: int = 2,
    rows: int = 3,
    cols: int = 4,
    splits: Dict[str, bool] = None,
    episodes_per_scene: int = 8,
    rir_length: int = 16000,
    wav_length: int = 16000,
    image_size: int = 128,
    passive_datapoints: int = 0,
    seed: int = 0,
) -> Dict:
    """Write the layout under `root` for `num_scenes` grid scenes named
    ``scene00``, ``scene01``, ... and the episode splits of `splits`
    ({split name: near_target}; near-target episodes start at the target,
    far-target ones at least 2 steps from it). With `passive_datapoints`,
    that many passive datapoints a scene and the held-out val sound pool.
    Returns {"opts": config overrides pointing at the layout, "bytes":
    {kind: bytes written}, "scenes": [names], "files": count}."""
    root = str(root)
    rng = np.random.default_rng(seed)
    splits = splits if splits is not None else {"train_nearTarget": True}
    names = [f"scene{i:02d}" for i in range(num_scenes)]
    scenes = {n: GraphScene.grid(n, rows, cols) for n in names}
    v = rows * cols
    sizes = dict.fromkeys(("metadata", "rirs", "mono", "frames", "episodes", "passive"), 0)
    files = 0

    for name, scene in scenes.items():
        sizes["metadata"] += write_scene_graph(os.path.join(root, "metadata", "mp3d"), scene)
        files += 2
        for az in AZIMUTHS:
            for r in range(v):
                dist = scene.bfs(r)
                for s in range(v):
                    sizes["rirs"] += _write_wav(
                        os.path.join(root, "binaural_rirs", "mp3d", name, str(az), f"{r}_{s}.wav"),
                        _rir(rng, int(dist[s]), az, rir_length),
                    )
                    files += 1

    t = np.arange(wav_length) / 16000.0
    pools = ("train", "val") if passive_datapoints else ("train",)
    for pool in pools:
        for cls, label in CLASS_NAMES_TO_LABELS.items():
            f0 = 60.0 * (label + 2) * (1.3 if pool == "val" else 1.0)
            sig = np.sin(2 * np.pi * f0 * t) + 0.5 * np.sin(2 * np.pi * 2.1 * f0 * t)
            sig = sig + 0.1 * rng.standard_normal(wav_length)
            wav = (sig / np.abs(sig).max() * 9000).astype(np.int16)
            sizes["mono"] += _write_wav(os.path.join(root, "audio_data", pool, f"{cls}_0.wav"), wav)
            files += 1

    for name in names:
        frames = {}
        for node in range(v):
            for rot in AZIMUTHS:
                base = rng.integers(0, 256, (image_size, image_size), dtype=np.uint8)
                frames[(node, rot)] = {
                    "rgb": np.stack([base, base // 2, 255 - base], axis=-1),
                    "depth": base.astype(np.float32) / 255.0,
                }
        path = os.path.join(root, "scene_observations", "mp3d", name + ".pkl")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as f:
            pickle.dump(frames, f)
        sizes["frames"] += os.path.getsize(path)
        files += 1

    labels = [lab for lab in CLASS_NAMES_TO_LABELS.values() if lab != ESC_LABEL]
    by_label = {lab: cls for cls, lab in CLASS_NAMES_TO_LABELS.items()}
    for split, near_target in splits.items():
        content = os.path.join(root, "datasets", "audio_separation", "v1", split, "content")
        os.makedirs(content, exist_ok=True)
        for name, scene in scenes.items():
            eps: List[dict] = []
            for i in range(episodes_per_scene):
                srcs = [int(x) for x in rng.choice(v, size=2, replace=False)]
                label = int(rng.choice(labels))
                other = int(rng.choice([lab for lab in CLASS_NAMES_TO_LABELS.values()
                                        if lab != label]))
                if near_target:
                    start = srcs[0]
                else:
                    far = [n for n in range(v) if scene.shortest_path_steps(n, srcs[0]) >= 2]
                    start = int(rng.choice(far))
                eps.append({
                    "episode_id": str(i),
                    "scene_id": f"mp3d/{name}/{name}.glb",
                    "start_position_index": start,
                    "start_rotation_angle": int(rng.choice(AZIMUTHS)),
                    "goals": [{"position_index": s} for s in srcs],
                    "info": [
                        {"sound": f"{by_label[label]}_0", "target_label": label,
                         "geodesic_distance": scene.geodesic_distance(start, srcs[0])},
                        {"sound": f"{by_label[other]}_0", "target_label": other},
                    ],
                })
            path = os.path.join(content, name + ".json.gz")
            with gzip.open(path, "wt") as f:
                json.dump({"episodes": eps}, f)
            sizes["episodes"] += os.path.getsize(path)
            files += 1

    for dp_split in ("train", "val") if passive_datapoints else ():
        dp_dir = os.path.join(root, "passive_datasets", "v1", dp_split)
        os.makedirs(dp_dir, exist_ok=True)
        for name in names:
            pts = [{"r": int(rng.integers(0, v)), "azimuth": int(rng.choice(AZIMUTHS)),
                    "all_s": [int(x) for x in rng.choice(v, size=2, replace=False)]}
                   for _ in range(passive_datapoints)]
            path = os.path.join(dp_dir, name + ".pkl")
            with open(path, "wb") as f:
                pickle.dump({name: pts}, f)
            sizes["passive"] += os.path.getsize(path)
            files += 1

    a, s = "TASK_CONFIG.SIMULATOR.AUDIO.", "TASK_CONFIG.SIMULATOR."
    opts = [
        a + "META_DIR", os.path.join(root, "metadata", "mp3d"),
        a + "RIR_DIR", os.path.join(root, "binaural_rirs", "mp3d"),
        a + "MONO_DIR", os.path.join(root, "audio_data", "train"),
        s + "RENDERED_OBSERVATIONS", os.path.join(root, "scene_observations"),
        "TASK_CONFIG.DATASET.DATA_PATH",
        os.path.join(root, "datasets", "audio_separation", "{version}", "{split}",
                     "{split}.json.gz"),
    ]
    if passive_datapoints:
        opts += [
            a + "SOURCE_AGENT_LOCATION_DATAPOINTS_DIR", os.path.join(root, "passive_datasets"),
            a + "PASSIVE_TRAIN_AUDIO_DIR", os.path.join(root, "audio_data", "train"),
            a + "PASSIVE_NONOVERLAPPING_VAL_AUDIO_DIR", os.path.join(root, "audio_data", "val"),
        ]
    return {"opts": opts, "bytes": sizes, "scenes": names, "files": files}

