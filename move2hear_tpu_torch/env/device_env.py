"""Device-resident AAViSS environment on tensors.

The whole environment lives on the device: the grid graph (positions,
padded adjacency, edge directions, all-pairs BFS distances); the episodes
as index tensors with a per-env cursor over an order table; and observation
banks (frames by node and rotation, the mono-waveform bank with its
precomputed rffts and GT mono spectrograms, and the binaural-RIR bank by
azimuth x receiver x source, optionally as precomputed rffts, or in its
place the episode-keyed slab of ``env/sub_bank.py``). An observation is
then a handful of gathers. Movement follows the reference
(simulator_train.py:267-353): orientation = (270 - rotation) mod 360,
azimuth = -rotation mod 360, forward walks to the FIRST adjacency-ordered
neighbor whose edge direction matches the orientation (or differs by
exactly 45 for diagonal edges), else stays put.

Index tensors are int64; every build_* function takes the target ``device``.
"""

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from move2hear_tpu_torch.env.micro_scene import MicroSceneBundle
from move2hear_tpu_torch.ops.convolve import fast_circular_len
from move2hear_tpu_torch.ops.stft import stft_mag_phase

PAUSE, MOVE_FORWARD, TURN_LEFT, TURN_RIGHT = 0, 1, 2, 3


@dataclass
class DeviceScene:
    """Scenes stacked on a leading axis, padded to the largest V/D."""

    positions: torch.Tensor   # (S, V, 3) f32
    neighbors: torch.Tensor   # (S, V, D) i64, -1 padded, adjacency order kept
    edge_dirs: torch.Tensor   # (S, V, D) i64 degrees, 0 where padded
    dist: torch.Tensor        # (S, V, V) i64 BFS steps, -1 unreachable
    grid_size: torch.Tensor   # (S,) f32


@dataclass
class DeviceEpisodes:
    start_node: torch.Tensor    # (E,)
    start_rot: torch.Tensor     # (E,) degrees
    sources: torch.Tensor       # (E, S) node ids, target first
    sound_ids: torch.Tensor     # (E, S)
    target_class: torch.Tensor  # (E,)
    start_geo: torch.Tensor     # (E,) f32
    scene_idx: torch.Tensor     # (E,) index into the DeviceScene stack


@dataclass
class DeviceEnvState:
    node: torch.Tensor        # (N,)
    rot: torch.Tensor         # (N,)
    step_count: torch.Tensor  # (N,) steps taken in the current episode
    ep: torch.Tensor          # (N,) current episode index
    cursor: torch.Tensor      # (N,) position in the order table
    order: torch.Tensor       # (N, K) per-env episode order
    prev_geo: torch.Tensor    # (N,) f32 geodesic distance before the step (nav reward)


class DeviceObs(NamedTuple):
    node: torch.Tensor
    rot_idx: torch.Tensor       # rotation / 90
    azimuth_idx: torch.Tensor   # azimuth / 90
    sound_ids: torch.Tensor     # (N, S)
    sources: torch.Tensor       # (N, S)
    target_class: torch.Tensor  # (N, 1)
    scene_idx: torch.Tensor     # (N,)
    ep: torch.Tensor            # (N,) episode index


@dataclass
class DeviceBundle:
    scene: DeviceScene
    episodes: DeviceEpisodes
    wav_bank: torch.Tensor                         # (num_sounds, L)
    rir_bank: Optional[torch.Tensor]               # (S, 4, V, V, R, 2); None in sub mode
    rgb_bank: Optional[torch.Tensor] = None        # (S, V, 4, H, W, 3) uint8
    depth_bank: Optional[torch.Tensor] = None      # (S, V, 4, H, W, 1)
    wav_rfft_bank: Optional[torch.Tensor] = None   # (num_sounds, NF, 2)
    gt_mono_bank: Optional[torch.Tensor] = None    # (num_sounds, F, T, 2)
    rir_rfft_bank: Optional[torch.Tensor] = None   # (S, 4, V, V, NF, 2, 2)
    # sub mode (env/sub_bank.py): in place of rir_bank, a slab of
    # per-(scene, source) rows and the episode -> slot table, which the
    # trainer sets for each rollout window
    rir_sub_bank: Optional[torch.Tensor] = None    # (ROWS, 4, V, R, 2)
    ep_src_row: Optional[torch.Tensor] = None      # (E, S_mix) int32


# --- bank and table construction ---------------------------------------------

def estimate_bank_bytes(bundle, image_size: int = 128) -> int:
    """Projected device bytes of a bundle's banks: the RIR bank, 4*V^2*R*2
    f32 per scene, dominates."""
    scenes = bundle.scenes
    v = max(s.num_nodes for s in scenes.values())
    r = bundle.audio_db.rir_length
    rir = len(scenes) * 4 * v * v * r * 2 * 4
    frames = len(scenes) * v * 4 * image_size * image_size * (3 * 1 + 1 * 4)
    wav = len(bundle.audio_db.sound_names()) * bundle.audio_db.wav_length * 4
    return rir + frames + wav


def estimate_rir_rfft_bytes(bundle) -> int:
    """Extra device bytes of the precomputed RIR-rfft bank on top of the
    dense bank: (..., NF, 2 ears, 2 re/im) f32 per RIR."""
    scenes = bundle.scenes
    v = max(s.num_nodes for s in scenes.values())
    r = bundle.audio_db.rir_length
    nf = fast_circular_len(bundle.audio_db.wav_length, r) // 2 + 1
    return len(scenes) * 4 * v * v * nf * 2 * 2 * 4


def make_order_table(num_envs: int, num_episodes: int, seed: int) -> np.ndarray:
    """(num_envs, K) per-env shuffled episode order: episodes split
    round-robin when there are enough, else a permutation of all per env
    (the JAX package's table, drawn from the same numpy seed)."""
    rng = np.random.default_rng(seed)
    if num_episodes >= num_envs:
        per = num_episodes // num_envs
        table = np.zeros((num_envs, per), np.int64)
        perm = rng.permutation(num_episodes)
        for i in range(num_envs):
            table[i] = perm[i * per : (i + 1) * per]
    else:
        table = np.stack([rng.permutation(num_episodes) for _ in range(num_envs)])
    return table.astype(np.int64)


def _scene_list(scenes) -> list:
    """Deterministic scene order: sorted by name."""
    return [scenes[k] for k in sorted(scenes)]


# scenes of this many nodes or more fill their all-pairs table through the
# C++ graph walker (move2hear_tpu/env/device_env.py:146-157's threshold)
NATIVE_MIN_NODES = 64


def build_device_scene(scenes, device) -> DeviceScene:
    """The scenes' graphs stacked on the device. The all-pairs BFS table of
    a scene of NATIVE_MIN_NODES or more (V^2 steps, the scene build's hot
    spot) comes from the C++ walker, attached here if the scene has none;
    smaller scenes without one take the Python BFS."""
    scene_list = _scene_list(scenes)
    v = max(s.num_nodes for s in scene_list)
    max_deg = max(max((len(ns) for ns in s.neighbors), default=1) for s in scene_list)
    n_sc = len(scene_list)
    positions = np.zeros((n_sc, v, 3), np.float64)
    neighbors = np.full((n_sc, v, max_deg), -1, np.int64)
    edge_dirs = np.zeros((n_sc, v, max_deg), np.int64)
    dist = np.full((n_sc, v, v), -1, np.int64)
    grid_size = np.zeros((n_sc,), np.float32)
    for si, scene in enumerate(scene_list):
        vs = scene.num_nodes
        positions[si, :vs] = scene.positions
        for i, ns in enumerate(scene.neighbors):
            for j, nb in enumerate(ns):
                neighbors[si, i, j] = nb
                edge_dirs[si, i, j] = scene.edge_direction(i, nb)
        if scene._native is None and vs >= NATIVE_MIN_NODES:
            scene.attach_native()
        if scene._native is not None:
            idx = np.arange(vs, dtype=np.int32)
            dist[si, :vs, :vs] = scene._native.geodesic_batch(
                np.repeat(idx, vs), np.tile(idx, vs)).reshape(vs, vs)  # int32 -> int64, -1 kept
        else:
            dist[si, :vs, :vs] = np.stack([scene.bfs(i) for i in range(vs)])
        grid_size[si] = scene.grid_size
    t = lambda a, dt=None: torch.as_tensor(a, dtype=dt, device=device)
    return DeviceScene(
        positions=t(positions, torch.float32),
        neighbors=t(neighbors),
        edge_dirs=t(edge_dirs),
        dist=t(dist),
        grid_size=t(grid_size),
    )


def build_device_episodes(episodes, audio_db, scenes, device) -> DeviceEpisodes:
    eps = episodes.episodes
    name_to_idx = {s.name: i for i, s in enumerate(_scene_list(scenes))}
    i64 = lambda xs: torch.tensor(xs, dtype=torch.long, device=device)
    return DeviceEpisodes(
        start_node=i64([e.start_node for e in eps]),
        start_rot=i64([e.start_rotation for e in eps]),
        sources=i64([e.source_nodes for e in eps]),
        sound_ids=i64([[audio_db.sound_id(n) for n in e.sound_names] for e in eps]),
        target_class=i64([e.target_class for e in eps]),
        start_geo=torch.tensor(
            [e.geodesic_distance for e in eps], dtype=torch.float32, device=device
        ),
        scene_idx=i64([name_to_idx[e.scene_id] for e in eps]),
    )


def build_rir_bank(scenes, audio_db, device) -> torch.Tensor:
    """(S scenes, 4 azimuths, V receivers, V sources, R, 2)."""
    scene_list = _scene_list(scenes)
    v = max(s.num_nodes for s in scene_list)
    bank = np.zeros((len(scene_list), 4, v, v, audio_db.rir_length, 2), np.float32)
    for si, scene in enumerate(scene_list):
        vs = scene.num_nodes
        for az_idx, az in enumerate((0, 90, 180, 270)):
            for recv in range(vs):
                for src in range(vs):
                    bank[si, az_idx, recv, src] = audio_db.get_rir(scene.name, az, recv, src)
    return torch.from_numpy(bank).to(device)


def build_frame_banks(scenes, frame_cache, device, height=128, width=128):
    """rgb (S, V, 4, H, W, 3) uint8 + depth (S, V, 4, H, W, 1) f32, indexed
    by (scene, node, rotation/90)."""
    scene_list = _scene_list(scenes)
    v = max(s.num_nodes for s in scene_list)
    n_sc = len(scene_list)
    rgb = np.zeros((n_sc, v, 4, height, width, 3), np.uint8)
    depth = np.zeros((n_sc, v, 4, height, width, 1), np.float32)
    for si, scene in enumerate(scene_list):
        for node in range(scene.num_nodes):
            for rot_idx, rot in enumerate((0, 90, 180, 270)):
                frames = frame_cache.get(scene.name, node, rot)
                rgb[si, node, rot_idx] = frames["rgb"]
                depth[si, node, rot_idx] = frames["depth"]
    return torch.from_numpy(rgb).to(device), torch.from_numpy(depth).to(device)


def build_wav_rfft_bank(wav_bank: torch.Tensor, rir_length: int) -> torch.Tensor:
    """(num_sounds, NF, 2) real/imag of rfft(mono, nfft) at the linear-conv
    FFT length: the mono forward FFTs are static per sound."""
    nfft = fast_circular_len(wav_bank.shape[-1], rir_length)
    f = torch.fft.rfft(wav_bank.to(torch.float32), n=nfft, dim=-1)
    return torch.stack([f.real, f.imag], dim=-1)


def build_rir_rfft_bank(rir_bank: torch.Tensor, mono_len: int) -> torch.Tensor:
    """(S, 4, V, V, NF, 2 ears, 2 re/im) rffts of the whole RIR bank, which
    removes the per-step RIR forward FFTs (TPU.PRECOMPUTE_RIR_RFFT)."""
    nfft = fast_circular_len(mono_len, rir_bank.shape[-2])
    f = torch.fft.rfft(rir_bank.to(torch.float32), n=nfft, dim=-2)
    return torch.stack([f.real, f.imag], dim=-1)


def build_gt_mono_bank(wav_bank: torch.Tensor) -> torch.Tensor:
    """(num_sounds, F, T, 2): raw GT mono STFT magnitude and its f16-cast
    phase, static per sound."""
    mag, phase = stft_mag_phase(wav_bank.to(torch.float32) * (1.0 / 32768.0))
    phase = phase.to(torch.float16).to(torch.float32)
    return torch.stack([mag, phase], dim=-1)


def build_device_bundle(
    bundle: MicroSceneBundle, device, episodes=None, precompute_rir_rfft: bool = False,
    rir_mode: str = "dense",
) -> DeviceBundle:
    """rir_mode "dense" builds the (S, 4, V, V, R, 2) RIR bank (and its
    rffts when asked); "sub" builds neither, and the trainer supplies the
    episode-keyed slab for each window (env/sub_bank.py)."""
    if rir_mode not in ("dense", "sub"):
        raise ValueError(f"rir_mode={rir_mode!r}: expected 'dense' or 'sub'")
    eps = episodes if episodes is not None else bundle.episodes
    scenes = bundle.scenes
    rgb_bank = depth_bank = None
    if bundle.frame_cache is not None:
        rgb_bank, depth_bank = build_frame_banks(scenes, bundle.frame_cache, device)
    wav_bank = torch.from_numpy(np.asarray(bundle.audio_db.mono_bank())).to(device)
    rir_bank = rir_rfft_bank = None
    if rir_mode == "dense":
        rir_bank = build_rir_bank(scenes, bundle.audio_db, device)
        if precompute_rir_rfft:
            rir_rfft_bank = build_rir_rfft_bank(rir_bank, int(wav_bank.shape[-1]))
    return DeviceBundle(
        scene=build_device_scene(scenes, device),
        episodes=build_device_episodes(eps, bundle.audio_db, scenes, device),
        wav_bank=wav_bank,
        rir_bank=rir_bank,
        rgb_bank=rgb_bank,
        depth_bank=depth_bank,
        wav_rfft_bank=build_wav_rfft_bank(wav_bank, bundle.audio_db.rir_length),
        gt_mono_bank=build_gt_mono_bank(wav_bank),
        rir_rfft_bank=rir_rfft_bank,
    )


# --- env dynamics ------------------------------------------------------------

def _forward_neighbor(scene: DeviceScene, scene_i, node, orientation):
    """Per env: the first adjacency-ordered neighbor of `node` matching the
    orientation, or `node` itself."""
    nbrs = scene.neighbors[scene_i, node]   # (N, D)
    dirs = scene.edge_dirs[scene_i, node]   # (N, D)
    cardinal = (dirs == 0) | (dirs == 90) | (dirs == 180) | (dirs == 270)
    ori = orientation[:, None]
    match = torch.where(cardinal, dirs == ori, (dirs - ori).abs() == 45) & (nbrs >= 0)
    first = torch.argmax(match.to(torch.int32), dim=1)
    chosen = torch.gather(nbrs, 1, first[:, None])[:, 0]
    return torch.where(match.any(dim=1), chosen, node)


def env_reset_all(
    scene: DeviceScene, episodes: DeviceEpisodes, order: torch.Tensor
) -> DeviceEnvState:
    """order: (N, K) per-env episode index table."""
    n = order.shape[0]
    ep = order[:, 0]
    zeros = torch.zeros((n,), dtype=torch.long, device=order.device)
    return DeviceEnvState(
        node=episodes.start_node[ep],
        rot=episodes.start_rot[ep],
        step_count=zeros,
        ep=ep,
        cursor=zeros.clone(),
        order=order,
        prev_geo=episodes.start_geo[ep],
    )


def env_step(
    scene: DeviceScene,
    episodes: DeviceEpisodes,
    state: DeviceEnvState,
    action_codes: torch.Tensor,   # (N,) sim action codes (PAUSE/FWD/L/R)
    max_episode_steps: int,
) -> Tuple[DeviceEnvState, dict]:
    """One step for all N envs, with auto-reset at the horizon (episode_over
    = step budget exhausted, environments.py:94-98). ``info["nav_reward"]``
    is the decrease of the geodesic distance to the target over the step."""
    scene_i = episodes.scene_idx[state.ep]
    orientation = (270 - state.rot) % 360
    fwd = _forward_neighbor(scene, scene_i, state.node, orientation)
    node = torch.where(action_codes == MOVE_FORWARD, fwd, state.node)
    rot = (
        state.rot
        + 90 * (action_codes == TURN_LEFT).long()
        - 90 * (action_codes == TURN_RIGHT).long()
    ) % 360

    step_count = state.step_count + 1
    done = step_count >= max_episode_steps

    target = episodes.sources[state.ep, 0]
    geo = scene.dist[scene_i, node, target].to(torch.float32) * scene.grid_size[scene_i]
    nav_reward = state.prev_geo - geo
    start_geo = episodes.start_geo[state.ep]
    ndg = torch.where(start_geo > 0, geo / start_geo, torch.full_like(geo, -1.0))

    k = state.order.shape[1]
    cursor_next = torch.where(done, (state.cursor + 1) % k, state.cursor)
    ep_next = torch.gather(state.order, 1, cursor_next[:, None])[:, 0]
    ep_next = torch.where(done, ep_next, state.ep)
    new_state = DeviceEnvState(
        node=torch.where(done, episodes.start_node[ep_next], node),
        rot=torch.where(done, episodes.start_rot[ep_next], rot),
        step_count=torch.where(done, torch.zeros_like(step_count), step_count),
        ep=ep_next,
        cursor=cursor_next,
        order=state.order,
        prev_geo=torch.where(done, episodes.start_geo[ep_next], geo),
    )
    return new_state, {"done": done, "nav_reward": nav_reward, "geo": geo, "ndg": ndg}


def observe(episodes: DeviceEpisodes, state: DeviceEnvState) -> DeviceObs:
    azimuth = (-state.rot) % 360
    return DeviceObs(
        node=state.node,
        rot_idx=(state.rot // 90) % 4,
        azimuth_idx=(azimuth // 90) % 4,
        sound_ids=episodes.sound_ids[state.ep],
        sources=episodes.sources[state.ep],
        target_class=episodes.target_class[state.ep][:, None],
        scene_idx=episodes.scene_idx[state.ep],
        ep=state.ep,
    )


def _gather_rirs(bundle: DeviceBundle, obs: DeviceObs) -> torch.Tensor:
    """(N, S_mix, R, 2) raw RIRs of each env's sources at its azimuth and
    receiver node: from the dense bank, or from the sub-bank slab through
    the episode -> slot table (a bfloat16 slab's rows widened to float32
    for the render)."""
    if bundle.rir_sub_bank is not None:
        rows = bundle.ep_src_row[obs.ep]  # (N, S_mix) slab slots
        rirs = bundle.rir_sub_bank[rows, obs.azimuth_idx[:, None], obs.node[:, None]]
        return rirs.float() if rirs.dtype == torch.bfloat16 else rirs
    return bundle.rir_bank[
        obs.scene_idx[:, None], obs.azimuth_idx[:, None], obs.node[:, None], obs.sources
    ]


def gather_sensors(bundle: DeviceBundle, obs: DeviceObs) -> dict:
    """Raw sensor inputs from the banks: the mono rffts + GT mono
    spectrograms, the RIRs (or their rffts) and the frames."""
    out = {
        "target_class": obs.target_class,
        "mono_rfft": bundle.wav_rfft_bank[obs.sound_ids],   # (N, S, NF, 2)
        "gt_mono_raw": bundle.gt_mono_bank[obs.sound_ids],  # (N, S, F, T, 2)
        "mono_len": int(bundle.wav_bank.shape[-1]),
    }
    if bundle.rir_rfft_bank is not None:
        out["rir_rfft"] = bundle.rir_rfft_bank[
            obs.scene_idx[:, None], obs.azimuth_idx[:, None], obs.node[:, None], obs.sources
        ]
        out["rir_len"] = int(bundle.rir_bank.shape[-2])
    else:
        out["rirs"] = _gather_rirs(bundle, obs)
    if bundle.rgb_bank is not None:
        out["rgb"] = bundle.rgb_bank[obs.scene_idx, obs.node, obs.rot_idx]
    if bundle.depth_bank is not None:
        out["depth"] = bundle.depth_bank[obs.scene_idx, obs.node, obs.rot_idx]
    return out
