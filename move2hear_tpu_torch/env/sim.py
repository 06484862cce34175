"""The AAViSS grid-graph simulator on the host
(``habitat_audio/simulator_train.py`` / ``simulator_eval.py``), one env in
numpy, the JAX package's ``env/sim.py``.

Movement, orientation and azimuth follow the reference:
  - actions PAUSE=0, MOVE_FORWARD=1, TURN_LEFT=2, TURN_RIGHT=3 (the
    STOP<->PAUSE index swap of action_space_separation.py:7-11 baked in)
  - TURN_LEFT: rotation += 90 (counterclockwise positive); TURN_RIGHT: -90
  - orientation = (270 - rotation) % 360; azimuth = -rotation % 360
  - MOVE_FORWARD walks to the first neighbor matching the orientation
    (``GraphScene.forward_neighbor``, with the exact-45-degree diagonal rule)
  - PAUSE raises in train mode and does nothing in eval mode
    (simulator_train.py:287-289 vs simulator_eval.py:286-290)

The sim exposes *render keys* (sound ids and the RIR arrays of the current
pose); the trainer and the evaluator render them batched on the device.
``render_audio_host`` is the reference's per-env numpy/scipy chain, kept
as the parity tool. It imports no torch: vector-env workers hold numpy only.
"""

import enum
from typing import Dict, List

import numpy as np

from move2hear_tpu_torch.env.episodes import Episode
from move2hear_tpu_torch.env.scene import GraphScene


class Action(enum.IntEnum):
    PAUSE = 0
    MOVE_FORWARD = 1
    TURN_LEFT = 2
    TURN_RIGHT = 3


class AAViSSSim:
    def __init__(
        self,
        scene,
        audio_db,
        frame_cache=None,
        eval_mode: bool = False,
        gt_mono_mag_norm: float = 0.0,
    ):
        # a GraphScene or {name: GraphScene}: a multi-scene sim switches scene
        # per episode, as habitat reconfigures per episode
        if isinstance(scene, GraphScene):
            self._scenes: Dict[str, GraphScene] = {scene.name: scene}
        else:
            self._scenes = dict(scene)
            assert self._scenes, "empty scene dict"
        self.scene = next(iter(self._scenes.values()))
        self.audio_db = audio_db
        self.frame_cache = frame_cache
        self.eval_mode = eval_mode
        self.gt_mono_mag_norm = gt_mono_mag_norm

        self._receiver = 0
        self._rotation = 0
        self._sources: List[int] = []
        self._sounds: List[str] = []
        self._target_class = 0
        self._is_episode_active = False

    # --- episode control -------------------------------------------------
    def reset(self, episode: Episode):
        assert episode.scene_id in self._scenes, (episode.scene_id, sorted(self._scenes))
        self.scene = self._scenes[episode.scene_id]
        self._receiver = int(episode.start_node)
        self._rotation = int(episode.start_rotation) % 360
        self._sources = list(episode.source_nodes)
        self._sounds = list(episode.sound_names)
        self._target_class = int(episode.target_class)
        self._is_episode_active = True
        return self.get_observations()

    def step(self, action: int):
        assert self._is_episode_active, "episode not active; call reset"
        action = int(action)
        if action == Action.MOVE_FORWARD:
            self._receiver = self.scene.forward_neighbor(self._receiver, self.get_orientation())
        elif action == Action.TURN_LEFT:
            self._rotation = (self._rotation + 90) % 360
        elif action == Action.TURN_RIGHT:
            self._rotation = (self._rotation - 90) % 360
        elif action == Action.PAUSE:
            if not self.eval_mode:
                raise ValueError("PAUSE not allowed during training")
        else:
            raise NotImplementedError(f"action {action}")
        return self.get_observations()

    # --- state -----------------------------------------------------------
    def get_orientation(self) -> int:
        return (270 - self._rotation) % 360

    @property
    def azimuth_angle(self) -> int:
        return -self._rotation % 360

    @property
    def rotation(self) -> int:
        return self._rotation

    @property
    def reaching_goal(self) -> bool:
        return self._sources[0] == self._receiver

    @property
    def target_class(self) -> int:
        return self._target_class

    @property
    def receiver_node(self) -> int:
        return self._receiver

    @property
    def source_nodes(self) -> List[int]:
        return list(self._sources)

    def geo_dist_to_target(self) -> float:
        return self.scene.geodesic_distance(self._receiver, self._sources[0])

    def euclid_dist_to_target(self) -> float:
        return self.scene.euclidean_distance(self._receiver, self._sources[0])

    # --- observations ----------------------------------------------------
    def audio_render_keys(self) -> Dict[str, np.ndarray]:
        """The batched render's inputs: per-source sound ids (S,) int32 and
        RIRs (S, R, 2) float32 at the current pose."""
        sound_ids = np.asarray([self.audio_db.sound_id(n) for n in self._sounds], np.int32)
        rirs = np.stack([
            self.audio_db.get_rir(self.scene.name, self.azimuth_angle, self._receiver, s)
            for s in self._sources
        ]).astype(np.float32)
        return {"sound_ids": sound_ids, "rirs": rirs}

    def get_observations(self) -> Dict[str, np.ndarray]:
        obs: Dict[str, np.ndarray] = {
            "target_class": np.asarray([self._target_class], np.int32),
        }
        if self.frame_cache is not None:
            frames = self.frame_cache.get(self.scene.name, self._receiver, self._rotation)
            if "rgb" in frames:
                obs["rgb"] = np.asarray(frames["rgb"], np.uint8)
            if "depth" in frames:
                obs["depth"] = frames["depth"].astype(np.float32)
        obs.update(self.audio_render_keys())
        return obs

    def render_audio_host(self) -> Dict[str, np.ndarray]:
        """The reference's host render of one env (simulator_train.py:386-486)
        in numpy/scipy: the 4 audio sensor arrays (F, T, C)."""
        from scipy.signal import fftconvolve

        gt_bin, gt_mono = [], []
        mixed = 0.0
        for s_idx, src in enumerate(self._sources):
            mono = self.audio_db.get_mono(self._sounds[s_idx])
            rir = self.audio_db.get_rir(self.scene.name, self.azimuth_angle, self._receiver, src)
            conv = np.array([fftconvolve(mono, rir[:, ch], mode="same") for ch in range(2)])
            conv = np.round(conv).astype("int16").astype("float32") * (1 / 32768)

            mag_l, ph_l = np_stft_mag_phase(conv[0])
            mag_r, ph_r = np_stft_mag_phase(conv[1])
            gt_bin.append(np.stack([mag_l, ph_l, mag_r, ph_r], axis=-1).astype(np.float16))

            m = mono.astype("float32") / 32768
            m_mag, m_ph = np_stft_mag_phase(m)
            if self.gt_mono_mag_norm != 0.0:
                rms = np.sqrt(np.mean(m_mag**2))
                if rms != 0.0:
                    m_mag = m_mag * self.gt_mono_mag_norm / rms
            gt_mono.append(np.stack([m_mag, m_ph], axis=-1).astype(np.float16))
            mixed = mixed + conv
        mixed = mixed / len(self._sources)
        mx_l, px_l = np_stft_mag_phase(mixed[0])
        mx_r, px_r = np_stft_mag_phase(mixed[1])
        mag = np.stack([mx_l, mx_r], axis=-1).astype(np.float16)
        phase = np.stack([px_l, px_r], axis=-1).astype(np.float16)
        return {
            "mixed_bin_audio_mag": np.log1p(mag).astype(np.float32),
            "mixed_bin_audio_phase": phase.astype(np.float32),
            "gt_bin_comps": np.concatenate(gt_bin, axis=2).astype(np.float32),
            "gt_mono_comps": np.concatenate(gt_mono, axis=2).astype(np.float32),
        }


def np_stft_mag_phase(y, n_fft: int = 1023, hop: int = 512):
    """librosa-style centred STFT (reflect padding, periodic Hann) of a 1-D
    signal: (magnitude, phase), each (n_fft // 2 + 1, frames)."""
    pad = n_fft // 2
    y = np.pad(y, pad, mode="reflect")
    win = 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n_fft) / n_fft))
    n = 1 + (len(y) - n_fft) // hop
    cols = [np.fft.rfft(y[i * hop : i * hop + n_fft] * win, n=n_fft) for i in range(n)]
    spec = np.stack(cols, axis=1)
    return np.abs(spec), np.angle(spec)
