"""Procedural audio asset store: mono source waveforms and binaural RIRs,
each mono sound with a stable integer id so a (num_sounds, L) device array
can be indexed by the env."""

import zlib
from typing import Dict, List, Tuple

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
