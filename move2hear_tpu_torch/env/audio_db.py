"""Audio asset stores: mono source waveforms and binaural RIRs, each mono
sound with a stable integer id so a (num_sounds, L) device array can be
indexed by the env. ``SyntheticAudioDB`` makes them from a seed;
``FileAudioDB`` reads the reference's on-disk layout. An unreadable or
empty RIR file reads as zeros (simulator_train.py:407-415)."""

import os
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np


class SyntheticAudioDB:
    """Procedural sounds (one per class name) + RIRs derived deterministically
    from (scene, azimuth, receiver, source), so every process sees identical
    data with no files. RIR energy decays with |receiver - source|."""

    def __init__(
        self,
        sound_names: List[str],
        wav_length: int = 16000,
        rir_length: int = 1000,
        seed: int = 0,
    ):
        self.wav_length = wav_length
        self.rir_length = rir_length
        self._names = list(sound_names)
        self._ids = {n: i for i, n in enumerate(self._names)}
        rng = np.random.default_rng(seed)
        t = np.arange(wav_length) / 16000.0
        bank = np.zeros((len(self._names), wav_length), np.float32)
        for i in range(len(self._names)):
            f0 = 70.0 * (i + 2)
            sig = sum(
                np.sin(2 * np.pi * f0 * (h + 1) * t + rng.uniform(0, 2 * np.pi))
                / (h + 1)
                for h in range(4)
            ) + 0.2 * rng.standard_normal(wav_length)
            bank[i] = (sig / np.abs(sig).max() * 9000.0).astype(np.float32)
        self._bank = bank
        self._rir_cache: Dict[Tuple, np.ndarray] = {}

    def sound_names(self):
        return list(self._names)

    def sound_id(self, name):
        return self._ids[name]

    def get_mono(self, name):
        return self._bank[self._ids[name]]

    def mono_bank(self):
        """(num_sounds, L) raw int16-scale float32 array, by sound_id."""
        return self._bank

    def get_rir(self, scene, azimuth, receiver, source):
        """(R, 2) float32."""
        key = (scene, int(azimuth), int(receiver), int(source))
        if key not in self._rir_cache:
            self._rir_cache[key] = self._make_rir(key)
        return self._rir_cache[key]

    def get_rir_block(self, scene, azimuth, source, num_receivers):
        """(num_receivers, R, 2) all-receiver column for one (scene, azimuth,
        source): the assembly of an episode-keyed sub-bank row. It reads
        the per-key cache but never fills it: a row is V x R x 2 floats, and
        caching each RIR would grow the host cache without bound."""
        out = np.empty((num_receivers, self.rir_length, 2), np.float32)
        for recv in range(num_receivers):
            key = (scene, int(azimuth), int(recv), int(source))
            cached = self._rir_cache.get(key)
            out[recv] = cached if cached is not None else self._make_rir(key)
        return out

    def _make_rir(self, key):
        scene, azimuth, receiver, source = key
        # crc32, not hash(): str hashes are randomized per process
        seed = zlib.crc32(repr(key).encode()) & 0xFFFFFFFF
        rng = np.random.default_rng(seed)
        rir = np.zeros((self.rir_length, 2), np.float32)
        dist = abs(int(receiver) - int(source)) + 1
        gain = 0.6 / dist
        for ear in range(2):
            n_taps = int(rng.integers(4, 12))
            taps = rng.integers(0, self.rir_length, n_taps)
            amps = (
                rng.uniform(0.1, 1.0, n_taps)
                * np.exp(-taps / (self.rir_length / 3.0))
                * gain
            )
            # crude interaural difference keyed to azimuth
            ear_gain = 1.0 + 0.3 * np.cos(np.deg2rad(azimuth + 180 * ear))
            rir[taps, ear] = (amps * rng.choice([-1, 1], n_taps) * ear_gain).astype(
                np.float32
            )
        return rir


class FileAudioDB:
    """The reference's on-disk layout: mono wavs at ``mono_dir/{name}.wav``
    (sound ids in sorted name order), RIR wavs at
    ``rir_dir/{scene}/{azimuth}/{receiver}_{source}.wav``
    (simulator_train.py:396-415), zero-padded or cut to ``rir_length``."""

    def __init__(
        self,
        mono_dir: str,
        rir_dir: str,
        wav_length: int = 16000,
        rir_length: int = 16000,
        rir_sampling_rate: int = 16000,
    ):
        from scipy.io import wavfile

        self._wavfile = wavfile
        self.wav_length = wav_length
        self.rir_length = rir_length
        self._rir_sampling_rate = rir_sampling_rate
        self._mono_dir = mono_dir
        self._rir_dir = rir_dir
        self._names = sorted(
            os.path.splitext(f)[0] for f in os.listdir(mono_dir) if f.endswith(".wav")
        )
        self._ids = {n: i for i, n in enumerate(self._names)}
        self._mono_cache: Dict[str, np.ndarray] = {}
        self._rir_cache: Dict[Tuple, np.ndarray] = {}
        self._bank: Optional[np.ndarray] = None

    def sound_names(self):
        return list(self._names)

    def sound_id(self, name):
        return self._ids[name]

    def get_mono(self, name):
        if name not in self._mono_cache:
            _, data = self._wavfile.read(os.path.join(self._mono_dir, name + ".wav"))
            data = np.asarray(data, np.float32)[: self.wav_length]
            if len(data) < self.wav_length:
                data = np.pad(data, (0, self.wav_length - len(data)))
            self._mono_cache[name] = data
        return self._mono_cache[name]

    def mono_bank(self):
        """(num_sounds, L) raw int16-scale float32 array, by sound_id."""
        if self._bank is None:
            self._bank = np.stack([self.get_mono(n) for n in self._names])
        return self._bank

    def get_rir(self, scene, azimuth, receiver, source):
        """(R, 2) float32, read once and cached."""
        key = (scene, int(azimuth), int(receiver), int(source))
        if key not in self._rir_cache:
            self._rir_cache[key] = self._read_rir(key)
        return self._rir_cache[key]

    def _read_rir(self, key):
        scene, azimuth, receiver, source = key
        path = os.path.join(
            self._rir_dir, scene, str(int(azimuth)), f"{int(receiver)}_{int(source)}.wav"
        )
        try:
            sr, rir = self._wavfile.read(path)
            assert sr == self._rir_sampling_rate
            rir = np.asarray(rir, np.float32)
            if rir.ndim == 1:
                rir = np.stack([rir, rir], axis=-1)
        except (ValueError, FileNotFoundError, AssertionError):
            rir = np.zeros((self.rir_length, 2), np.float32)
        if len(rir) == 0:
            rir = np.zeros((self.rir_length, 2), np.float32)
        out = np.zeros((self.rir_length, 2), np.float32)
        n = min(len(rir), self.rir_length)
        out[:n] = rir[:n]
        return out

    def get_rir_block(self, scene, azimuth, source, num_receivers):
        """(num_receivers, R, 2) all-receiver column, read past the cache
        (see SyntheticAudioDB.get_rir_block)."""
        out = np.empty((num_receivers, self.rir_length, 2), np.float32)
        for recv in range(num_receivers):
            key = (scene, int(azimuth), int(recv), int(source))
            cached = self._rir_cache.get(key)
            out[recv] = cached if cached is not None else self._read_rir(key)
        return out
