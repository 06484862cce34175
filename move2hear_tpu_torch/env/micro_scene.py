"""Scene bundles, and the synthetic micro-scene: a small grid scene +
procedural audio DB + frame cache + generated episodes, the data source of
the trainers and evaluators when no file-backed Matterport3D/SoundSpaces
data is configured (file-backed bundles: env/bundle.py)."""

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Union

from move2hear_tpu_torch.env.audio_db import SyntheticAudioDB
from move2hear_tpu_torch.env.environment import AAViSSEnv
from move2hear_tpu_torch.env.episodes import EpisodeDataset, generate_episodes
from move2hear_tpu_torch.env.frame_cache import SyntheticFrameCache
from move2hear_tpu_torch.env.scene import GraphScene
from move2hear_tpu_torch.env.sim import AAViSSSim

DEFAULT_SOUNDS = [f"class{i}" for i in range(10)] + ["music", "esc"]


@dataclass
class MicroSceneBundle:
    """Scene graph(s) + audio DB + frame cache + episodes: the generic
    bundle, synthetic or file-backed (``env/bundle.py:bundle_from_config``,
    whose ``FileAudioDB`` also serves the device paths' RIR banks and
    sub-bank rows)."""

    scene: Union[GraphScene, Dict[str, GraphScene]]
    audio_db: SyntheticAudioDB
    frame_cache: Optional[SyntheticFrameCache]
    episodes: EpisodeDataset

    @property
    def scenes(self) -> Dict[str, GraphScene]:
        if isinstance(self.scene, GraphScene):
            return {self.scene.name: self.scene}
        return self.scene

    @property
    def single_scene(self) -> GraphScene:
        scenes = self.scenes
        assert len(scenes) == 1, f"bundle holds {len(scenes)} scenes; this code path is single-scene"
        return next(iter(scenes.values()))

    def for_scenes(self, names) -> "MicroSceneBundle":
        """The sub-bundle of the named scenes: their episodes, the same audio
        DB and frame cache."""
        return MicroSceneBundle(
            scene={n: self.scenes[n] for n in names},
            audio_db=self.audio_db,
            frame_cache=self.frame_cache,
            episodes=self.episodes.filter_by_scenes(list(names)),
        )

    def make_env_fn(
        self,
        max_episode_steps: int = 20,
        with_distance_reward: bool = False,
        distance_reward_scale: float = 1.0,
        eval_mode: bool = False,
        gt_mono_mag_norm: float = 1.2,
        seed: int = 0,
        shuffle_episodes: bool = True,
        episodes: Optional[EpisodeDataset] = None,
        possible_actions=("MOVE_FORWARD", "TURN_LEFT", "TURN_RIGHT"),
    ) -> Callable[[], AAViSSEnv]:
        """A function that builds one host env over this bundle (all its
        episodes, or `episodes`)."""
        bundle = self

        def make():
            sim = AAViSSSim(bundle.scene, bundle.audio_db, bundle.frame_cache,
                            eval_mode=eval_mode, gt_mono_mag_norm=gt_mono_mag_norm)
            return AAViSSEnv(
                sim, episodes if episodes is not None else bundle.episodes,
                max_episode_steps=max_episode_steps,
                with_distance_reward=with_distance_reward,
                distance_reward_scale=distance_reward_scale,
                seed=seed, shuffle_episodes=shuffle_episodes,
                possible_actions=possible_actions,
            )

        return make


def build_micro_scene(
    rows: int = 4,
    cols: int = 4,
    num_episodes: int = 16,
    near_target: bool = True,
    rir_length: int = 1000,
    wav_length: int = 16000,
    image_size: int = 128,
    seed: int = 0,
    name: str = "micro",
    unheard_sounds: bool = False,
) -> MicroSceneBundle:
    """unheard_sounds: a disjoint procedural sound pool (same classes,
    different waveforms), the analog of the unheard-sound eval splits."""
    scene = GraphScene.grid(name, rows, cols)
    audio_db = SyntheticAudioDB(
        DEFAULT_SOUNDS,
        wav_length=wav_length,
        rir_length=rir_length,
        seed=seed + (10_000 if unheard_sounds else 0),
    )
    frame_cache = SyntheticFrameCache(image_size, image_size)
    episodes = generate_episodes(
        scene,
        DEFAULT_SOUNDS,
        num_episodes,
        near_target=near_target,
        seed=seed,
        esc_sounds=("esc",),
    )
    return MicroSceneBundle(scene, audio_db, frame_cache, episodes)


def build_scale_fixture(
    num_scenes: int = 8,
    rows: int = 15,
    cols: int = 20,
    episodes_per_scene: int = 12,
    rir_length: int = 16000,
    wav_length: int = 16000,
    with_frames: bool = True,
    near_target: bool = True,
    seed: int = 0,
) -> MicroSceneBundle:
    """A synthetic fixture at real scene scale: ``num_scenes`` grid scenes
    (``scale00``, ``scale01``, ...) of V = rows*cols nodes each (Matterport
    graphs hold about 100-1000 nodes) with full-length 16 kHz RIRs, and the
    episodes of every scene (scene i drawn from seed ``seed + 101*i``) in
    one dataset. Its dense RIR bank grows with V^2 per scene and does not
    fit a device, so it trains through the episode-keyed sub-banks
    (env/sub_bank.py)."""
    scenes = {}
    episodes = []
    for i in range(num_scenes):
        name = f"scale{i:02d}"
        scenes[name] = GraphScene.grid(name, rows, cols)
        episodes += generate_episodes(
            scenes[name],
            DEFAULT_SOUNDS,
            episodes_per_scene,
            near_target=near_target,
            seed=seed + 101 * i,
            esc_sounds=("esc",),
        ).episodes
    audio_db = SyntheticAudioDB(
        DEFAULT_SOUNDS, wav_length=wav_length, rir_length=rir_length, seed=seed,
    )
    frame_cache = SyntheticFrameCache() if with_frames else None
    return MicroSceneBundle(
        scene=scenes,
        audio_db=audio_db,
        frame_cache=frame_cache,
        episodes=EpisodeDataset(episodes),
    )
