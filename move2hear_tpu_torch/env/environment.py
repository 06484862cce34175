"""The RL environment on the host (``common/environments.py:17-105`` and the
task measures of ``habitat_audio/task.py:210-277``), the JAX package's
``env/environment.py``: episode iteration with auto-reset at the horizon,
the geodesic-distance-delta navigation reward (far-target), the done flag
and the distance measures in info. Separation rewards are the trainer's,
as in the reference."""

from typing import Dict

import numpy as np

from move2hear_tpu_torch.env.episodes import Episode, EpisodeDataset
from move2hear_tpu_torch.env.sim import AAViSSSim, Action


class AAViSSEnv:
    def __init__(
        self,
        sim: AAViSSSim,
        dataset: EpisodeDataset,
        max_episode_steps: int = 20,
        with_distance_reward: bool = True,
        distance_reward_scale: float = 1.0,
        shuffle_episodes: bool = True,
        seed: int = 0,
        loop_episodes: bool = True,
        possible_actions=("MOVE_FORWARD", "TURN_LEFT", "TURN_RIGHT"),
    ):
        assert len(dataset) > 0, "empty episode dataset"
        self.sim = sim
        self.dataset = dataset
        # the policy's action i names POSSIBLE_ACTIONS[i]; the published
        # configs use the 3-action space without PAUSE (configs/tasks/*/*.yaml)
        self._action_codes = [int(Action[name]) for name in possible_actions]
        self.max_episode_steps = max_episode_steps
        self._with_distance_reward = with_distance_reward
        self._distance_reward_scale = distance_reward_scale
        self._loop = loop_episodes
        self._order = np.arange(len(dataset))
        self._rng = np.random.default_rng(seed)
        if shuffle_episodes:
            self._rng.shuffle(self._order)
        self._shuffle = shuffle_episodes
        self._cursor = -1
        self._step_count = 0
        self._prev_target_distance = 0.0

    @property
    def current_episode(self) -> Episode:
        return self.dataset.episodes[self._order[self._cursor]]

    @property
    def episode_over(self) -> bool:
        return self._step_count >= self.max_episode_steps

    def number_of_episodes(self) -> int:
        return len(self.dataset)

    def seed(self, seed: int):
        self._rng = np.random.default_rng(seed)

    def reset(self) -> Dict[str, np.ndarray]:
        self._cursor += 1
        if self._cursor >= len(self._order):
            if not self._loop:
                raise StopIteration("episode iterator exhausted")
            self._cursor = 0
            if self._shuffle:
                self._rng.shuffle(self._order)
        self._step_count = 0
        episode = self.current_episode
        obs = self.sim.reset(episode)
        # reward baseline: the episode's precomputed geodesic (environments.py:46-47)
        self._prev_target_distance = episode.geodesic_distance
        return obs

    @property
    def num_actions(self) -> int:
        return len(self._action_codes)

    def step(self, action: int):
        """(obs, reward, done, info); at done the env resets itself and obs
        is the next episode's first observation (env_utils.py:185-196)."""
        obs = self.sim.step(self._action_codes[int(action)])
        self._step_count += 1

        reward = 0.0
        if self._with_distance_reward:
            current = self.sim.geo_dist_to_target()
            reward += (self._prev_target_distance - current) * self._distance_reward_scale
            self._prev_target_distance = current

        done = self.episode_over
        info = self.get_metrics()
        if done:
            obs = self.reset()
        return obs, reward, done, info

    def get_metrics(self) -> Dict[str, float]:
        geo = self.sim.geo_dist_to_target()
        start = self.current_episode.geodesic_distance
        # normalized: ratio to the start distance, -1 when that is 0
        # (task.py:244-277)
        ndg = geo / start if start > 0 else -1.0
        return {
            "geo_distance_to_target_audio_source": geo,
            "normalized_geo_distance_to_target_audio_source": ndg,
            "euclid_distance_to_target_audio_source": self.sim.euclid_dist_to_target(),
        }
