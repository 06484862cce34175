"""Passive pretraining data (the reference's
``audio_separation/pretrain/datasets/dataset.py``), the JAX package's
``pretrain/dataset.py`` in numpy, copied so that the port imports nothing
of that package.

A data source assembles *waveform* batches (mono wavs + RIRs + target
class); the trainer renders the spectrograms on the device with
``ops.frontend.render_binaural_mixture``. ``SyntheticPassiveSource`` makes
procedural sounds and RIRs from a seed, with no Matterport/SoundSpaces
data, and yields the same batches as the JAX package's for the same
generator state. ``FilePassiveSource`` reads the reference's on-disk
layout (datapoint pickles, RIR wavs, class-named mono wavs).

Class vocabulary as dataset.py:13-17 (10 VoxCeleb speakers + music + esc,
esc never a target). The train split resamples sounds every batch (data
augmentation, dataset.py:110-127); val splits are deterministic.
"""

import os
import pickle
from typing import Dict, List, Optional, Protocol

import numpy as np

CLASS_NAMES_TO_LABELS = {
    "id10393": 0, "id10583": 1, "id10061": 2, "id10954": 3, "id10355": 4,
    "id10799": 5, "id10203": 6, "id10371": 7, "id10361": 8, "id10254": 9,
    "music": 10, "esc": 11,
}
LABELS_TO_CLASS_NAMES = {v: k for k, v in CLASS_NAMES_TO_LABELS.items()}
ESC_LABEL = 11
NUM_CLASSES = len(CLASS_NAMES_TO_LABELS)


def sample_classes(rng: np.random.Generator, num_sources: int = 2) -> np.ndarray:
    """Sample distinct classes; resample while the target (index 0) is the
    distractor-only esc class (dataset.py:136-143)."""
    while True:
        classes = rng.permutation(NUM_CLASSES)[:num_sources]
        if classes[0] != ESC_LABEL:
            return classes


class PassiveDataSource(Protocol):
    num_sources: int
    wav_length: int
    rir_length: int

    def __len__(self) -> int: ...

    def sample_batch(
        self, rng: np.random.Generator, batch_size: int, deterministic: bool = False,
        start: int = 0,
    ) -> Dict[str, np.ndarray]:
        """Returns {'mono_wavs': (B, S, L) float32 raw int16-scale,
        'rirs': (B, S, R, 2) float32, 'target_class': (B, 1) int32}."""
        ...


class SyntheticPassiveSource:
    """Procedural scene: each class gets harmonically distinct sounds; each
    datapoint gets a sparse exponentially-decaying binaural RIR."""

    def __init__(
        self,
        num_datapoints: int = 256,
        num_sources: int = 2,
        wav_length: int = 16000,
        rir_length: int = 2000,
        variants_per_class: int = 3,
        seed: int = 0,
    ):
        self.num_sources = num_sources
        self.wav_length = wav_length
        self.rir_length = rir_length
        self._n = num_datapoints
        rng = np.random.default_rng(seed)

        # class sounds: f0 per class, few harmonics + noise, int16 scale
        t = np.arange(wav_length) / 16000.0
        self._wavs = np.zeros((NUM_CLASSES, variants_per_class, wav_length), np.float32)
        for c in range(NUM_CLASSES):
            for v in range(variants_per_class):
                f0 = 80.0 * (c + 1) + 13.0 * v
                sig = sum(
                    np.sin(2 * np.pi * f0 * (h + 1) * t + rng.uniform(0, 2 * np.pi))
                    / (h + 1)
                    for h in range(4)
                )
                sig = sig + 0.2 * rng.standard_normal(wav_length)
                sig = sig / np.abs(sig).max() * 9000.0
                self._wavs[c, v] = sig.astype(np.float32)

        # per-datapoint RIRs: sparse taps with exponential decay, 2 ears
        self._rirs = np.zeros((self._n, num_sources, rir_length, 2), np.float32)
        for i in range(self._n):
            for s in range(num_sources):
                for ear in range(2):
                    n_taps = rng.integers(5, 20)
                    taps = rng.integers(0, rir_length, n_taps)
                    amps = rng.uniform(0.02, 0.5, n_taps) * np.exp(
                        -taps / (rir_length / 3)
                    )
                    signs = rng.choice([-1.0, 1.0], n_taps)
                    self._rirs[i, s, taps, ear] = (amps * signs).astype(np.float32)
        self._variants = variants_per_class

    def __len__(self):
        return self._n

    def sample_batch(self, rng, batch_size, deterministic=False, start=0):
        if deterministic:
            idx = (start + np.arange(batch_size)) % self._n
            det_rng = np.random.default_rng(42 + start)
            classes = np.stack(
                [sample_classes(det_rng, self.num_sources) for _ in range(batch_size)]
            )
            variants = det_rng.integers(0, self._variants, (batch_size, self.num_sources))
        else:
            idx = rng.integers(0, self._n, batch_size)
            classes = np.stack(
                [sample_classes(rng, self.num_sources) for _ in range(batch_size)]
            )
            variants = rng.integers(0, self._variants, (batch_size, self.num_sources))

        mono = self._wavs[classes, variants]  # (B, S, L)
        rirs = self._rirs[idx]  # (B, S, R, 2)
        return {
            "mono_wavs": mono,
            "rirs": rirs,
            "target_class": classes[:, :1].astype(np.int32),
        }


class FilePassiveSource:
    """The reference's on-disk dataset layout (dataset.py:39-105):
    ``datapoints_dir/{scene}.pkl`` -> {scene: [{'r': int, 'azimuth': int,
    'all_s': [int]}]}; RIR wavs under ``rir_dir/{scene}/{azimuth}/{r}_{s}.wav``;
    mono wavs named ``{class}_*.wav`` under ``audio_dir``. An unreadable or
    empty RIR reads as zeros (dataset.py:170-176). Batches as
    ``SyntheticPassiveSource.sample_batch``."""

    def __init__(
        self,
        datapoints_dir: str,
        rir_dir: str,
        audio_dir: str,
        scenes: List[str],
        num_sources: int = 2,
        wav_length: int = 16000,
        rir_length: int = 16000,
        max_datapoints_per_scene: Optional[int] = None,
    ):
        from scipy.io import wavfile

        self.num_sources = num_sources
        self.wav_length = wav_length
        self.rir_length = rir_length
        self._rir_dir = rir_dir
        self._wavfile = wavfile

        self._audio_by_class: Dict[int, List[np.ndarray]] = {}
        for fname in sorted(os.listdir(audio_dir)):
            cls = fname.split("_")[0]
            if cls not in CLASS_NAMES_TO_LABELS:
                continue
            _, data = wavfile.read(os.path.join(audio_dir, fname))
            data = np.asarray(data, np.float32)[:wav_length]
            if len(data) < wav_length:
                data = np.pad(data, (0, wav_length - len(data)))
            self._audio_by_class.setdefault(CLASS_NAMES_TO_LABELS[cls], []).append(data)

        self._datapoints: List[List[str]] = []  # per datapoint, its sources' RIR paths
        for scene in scenes:
            with open(os.path.join(datapoints_dir, scene + ".pkl"), "rb") as f:
                pts = pickle.load(f)[scene]
            if max_datapoints_per_scene:
                pts = pts[:max_datapoints_per_scene]
            for p in pts:
                self._datapoints.append([
                    os.path.join(rir_dir, scene, str(p["azimuth"]), f"{p['r']}_{s}.wav")
                    for s in p["all_s"][:num_sources]
                ])
        self._rir_cache: Dict[str, np.ndarray] = {}

    def __len__(self):
        return len(self._datapoints)

    def _load_rir(self, path: str) -> np.ndarray:
        if path in self._rir_cache:
            return self._rir_cache[path]
        try:
            _, rir = self._wavfile.read(path)
            rir = np.asarray(rir, np.float32)
            if rir.ndim == 1:
                rir = np.stack([rir, rir], axis=-1)
        except (ValueError, FileNotFoundError):
            rir = np.zeros((self.rir_length, 2), np.float32)
        if len(rir) == 0:
            rir = np.zeros((self.rir_length, 2), np.float32)
        out = np.zeros((self.rir_length, 2), np.float32)
        n = min(len(rir), self.rir_length)
        out[:n] = rir[:n]
        self._rir_cache[path] = out
        return out

    def sample_batch(self, rng, batch_size, deterministic=False, start=0):
        if deterministic:
            idx = (start + np.arange(batch_size)) % len(self._datapoints)
            local_rng = np.random.default_rng(42 + start)
        else:
            idx = rng.integers(0, len(self._datapoints), batch_size)
            local_rng = rng

        mono = np.zeros((batch_size, self.num_sources, self.wav_length), np.float32)
        rirs = np.zeros((batch_size, self.num_sources, self.rir_length, 2), np.float32)
        targets = np.zeros((batch_size, 1), np.int32)
        for b, i in enumerate(idx):
            classes = sample_classes(local_rng, self.num_sources)
            targets[b, 0] = classes[0]
            for s, path in enumerate(self._datapoints[i]):
                variants = self._audio_by_class[classes[s]]
                mono[b, s] = variants[local_rng.integers(0, len(variants))]
                rirs[b, s] = self._load_rir(path)
        return {"mono_wavs": mono, "rirs": rirs, "target_class": targets}
