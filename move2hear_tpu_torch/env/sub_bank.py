"""Episode-keyed RIR sub-banks: the V-linear device-env route for scenes at
real scale (the JAX package's ``env/sub_bank.py``).

The dense device RIR bank is ``(S, 4, V, V, R, 2)``, V^2 per scene: at
Matterport sizes (V ~ 300-1000 nodes, R = 16000) it takes terabytes. But
an episode fixes its sources (the reference merges them into the sim
config at episode start, habitat_audio/task.py:20-53, and reads one RIR wav
per source per step, simulator_train.py:396-415), so a rollout only ever
gathers the RIRs of (any receiver node, the episode's <= NUM_SOUNDS_IN_MIX
sources). A "row", all receivers x 4 azimuths for one (scene, source
node), is V-linear: ``(4, V, R, 2)``.

This module keeps a preallocated device slab of such rows and an
``(E, S_mix)`` episode -> slot table, refreshed once per rollout window:

  - the device env's episode progression is deterministic (auto-reset at
    the horizon, a cursor over a host-built order table;
    ``env/device_env.py:env_step``), so the host predicts which episodes
    every env occupies over the next T steps without reading the device;
  - rows for newly active sources are assembled on the host from the audio
    store (``get_rir_block``) and written into their slot in place, through
    pinned staging buffers with ``non_blocking`` copies on the current
    stream: the host does not wait for the device, and the writes run after
    the collect and update already queued on that stream, which may still
    read the rows being replaced;
  - eviction is Belady's: the future occupancy is exactly known.

The collect's gather becomes ``slab[ep_src_row[ep], azimuth, node]``
(``env/device_env.py:gather_sensors``), bitwise equal to the dense gather.
A bfloat16 slab (``TPU.SUB_BANK_DTYPE``) halves the slab and the uploads:
rows are rounded to bfloat16 on the host (torch's cast, round to nearest
even) before they are cached and uploaded, and the gather widens them to
float32 for the render.
"""

import math
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

AZIMUTHS = (0, 90, 180, 270)
# pinned host buffers a GPU upload cycles through: one row is copied while
# the next is assembled
N_STAGING = 2
# host LRU cache of assembled rows, by bytes, when the slab holds fewer
# slots than there are (scene, source) keys
HOST_CACHE_BYTES = 16 * 1024**3


class EpisodeOccupancy:
    """Host mirror of the device env's episode progression
    (``env/device_env.py:env_step``): the step count rises every step; at
    the horizon the env resets and its cursor moves one slot on (mod K)."""

    def __init__(self, order: np.ndarray, horizon: int):
        self.order = np.asarray(order)
        self.horizon = int(horizon)
        n = self.order.shape[0]
        self.cursor = np.zeros(n, np.int64)
        self.step = np.zeros(n, np.int64)

    def episodes_for_window(self, t_steps: int) -> np.ndarray:
        """Sorted unique episode ids any env occupies during the next
        ``t_steps`` steps, the bootstrap observation after them included
        (the collect's last forward observes the post-step state, which may
        be a freshly reset episode)."""
        return self.episodes_by_window(1, t_steps)[0]

    def episodes_by_window(self, n_windows: int, t_steps: int) -> List[np.ndarray]:
        """The episodes of each of the next ``n_windows`` windows of
        ``t_steps`` steps, without moving the cursor. Window 0 is what
        ``episodes_for_window`` returns; later windows feed the eviction
        rank."""
        out = []
        k = self.order.shape[1]
        cur = self.cursor.copy()
        stp = self.step.copy()
        for _ in range(n_windows):
            need = set()
            for i in range(self.order.shape[0]):
                c, s = int(cur[i]), int(stp[i])
                need.add(int(self.order[i, c % k]))
                for _ in range(t_steps):
                    s += 1
                    if s >= self.horizon:
                        s = 0
                        c += 1
                        need.add(int(self.order[i, c % k]))
                cur[i], stp[i] = c, s
            out.append(np.asarray(sorted(need), np.int64))
        return out

    def advance(self, t_steps: int) -> None:
        """Commit ``t_steps`` steps that the device env ran."""
        k = self.order.shape[1]
        for i in range(self.order.shape[0]):
            c, s = int(self.cursor[i]), int(self.step[i])
            for _ in range(t_steps):
                s += 1
                if s >= self.horizon:
                    s = 0
                    c += 1
            self.cursor[i], self.step[i] = c, s


def sub_bank_capacity(
    n_envs: int, s_mix: int, t_steps: int, horizon: int,
    n_unique_keys: Optional[int] = None,
) -> int:
    """Slot count: the most (scene, source) keys one window can touch, plus
    25% so that the rows two consecutive windows share stay resident."""
    per_window = n_envs * s_mix * (math.ceil(t_steps / max(1, horizon)) + 1)
    cap = math.ceil(1.25 * per_window)
    if n_unique_keys is not None:
        cap = min(cap, n_unique_keys)
    assert cap >= min(per_window, n_unique_keys or per_window)
    return cap


def max_capacity_for_budget(
    budget_bytes: int, row_bytes: int, min_capacity: int,
    n_unique_keys: Optional[int] = None,
) -> int:
    """The most slots the byte budget allows: at least ``min_capacity`` (one
    window's need) and at most the dataset's unique key count. Every extra
    resident row turns a later re-upload into a hit."""
    cap = max(min_capacity, budget_bytes // max(1, row_bytes))
    if n_unique_keys is not None:
        cap = min(cap, max(min_capacity, n_unique_keys))
    return int(cap)


def fixed_bank_bytes(bundle, image_size: int = 128) -> int:
    """Device bytes the sub-bank route needs beside the slab: the frame
    banks (rgb uint8 and depth float32 per node and rotation) and the
    source-waveform bank."""
    scenes = bundle.scenes
    v = max(s.num_nodes for s in scenes.values())
    frames = 0
    if getattr(bundle, "frame_cache", None) is not None:
        frames = len(scenes) * v * 4 * image_size * image_size * (3 * 1 + 1 * 4)
    wav = len(bundle.audio_db.sound_names()) * bundle.audio_db.wav_length * 4
    return frames + wav


def estimate_sub_bank_bytes(
    bundle, n_envs: int, s_mix: int, t_steps: int, horizon: int,
    dtype_bytes: int = 4, image_size: int = 128,
) -> int:
    """The least device bytes of the sub-bank route: the slab at one
    window's capacity (the trainer grows it into the spare budget) and the
    fixed banks (cf. ``device_env.estimate_bank_bytes`` for the dense
    route)."""
    scenes = bundle.scenes
    v = max(s.num_nodes for s in scenes.values())
    r = bundle.audio_db.rir_length
    cap = sub_bank_capacity(n_envs, s_mix, t_steps, horizon, _count_unique_keys(bundle))
    return cap * row_bytes(v, r, dtype_bytes) + fixed_bank_bytes(bundle, image_size)


def row_bytes(v_pad: int, rir_length: int, dtype_bytes: int = 4) -> int:
    """Bytes of one slab row, ``(4, V_pad, R, 2)``."""
    return 4 * int(v_pad) * int(rir_length) * 2 * dtype_bytes


def _count_unique_keys(bundle) -> int:
    keys = set()
    for e in bundle.episodes.episodes:
        for src in e.source_nodes:
            keys.add((e.scene_id, int(src)))
    return len(keys)


class RirSubBank:
    """A preallocated ``(capacity, 4, V_pad, R, 2)`` slab (of `dtype`) of
    per-(scene, source) RIR rows on ``device`` and the episode -> slot
    table, refreshed per rollout window. ``row_bytes`` is the size of one
    row. Counters: ``rows_assembled``,
    ``rows_uploaded``, ``bytes_uploaded``; the host seconds spent in
    ``rollout_inputs`` and ``prefetch`` (``host_s``); and, on a GPU, how
    many prefetches returned while the device still ran the work queued
    before them (``prefetch_busy_returns``: their host work was hidden)."""

    def __init__(
        self,
        scenes,                     # {name: GraphScene}, taken in sorted-name order
        audio_db,
        ep_scene_idx: np.ndarray,   # (E,) scene index per episode
        ep_sources: np.ndarray,     # (E, S_mix) source node per slot
        order: np.ndarray,          # (N, K) per-env episode order
        horizon: int,
        t_steps: int,
        v_pad: int,
        capacity: Optional[int] = None,
        device="cpu",
        dtype: torch.dtype = torch.float32,
    ):
        self._scene_list = [scenes[k] for k in sorted(scenes)]
        self._audio_db = audio_db
        self._ep_scene_idx = np.asarray(ep_scene_idx, np.int64)
        self._ep_sources = np.asarray(ep_sources, np.int64)
        self._occ = EpisodeOccupancy(order, horizon)
        self._t_steps = int(t_steps)
        self._v_pad = int(v_pad)
        self._rir_len = int(audio_db.rir_length)
        n_envs, s_mix = self._occ.order.shape[0], self._ep_sources.shape[1]
        n_keys = len({
            (int(self._ep_scene_idx[e]), int(s))
            for e in range(len(self._ep_scene_idx))
            for s in self._ep_sources[e]
            if s >= 0
        })
        self.capacity = int(
            capacity if capacity is not None
            else sub_bank_capacity(n_envs, s_mix, t_steps, horizon, n_keys)
        )
        self.dtype = dtype
        self.row_bytes = row_bytes(self._v_pad, self._rir_len, dtype.itemsize)
        device = torch.device(device)
        self._slab = torch.zeros(
            (self.capacity, 4, self._v_pad, self._rir_len, 2), dtype=dtype, device=device
        )
        self._key_to_slot: Dict[Tuple[int, int], int] = {}
        self._slot_key: List[Optional[Tuple[int, int]]] = [None] * self.capacity
        self._slot_tick = np.zeros(self.capacity, np.int64)
        self._tick = 0
        self._table = np.zeros(self._ep_sources.shape, np.int32)
        self._table_dev = torch.zeros(self._ep_sources.shape, dtype=torch.int32, device=device)
        # pinned staging on a GPU: a copy from pageable memory would wait
        # for everything queued on the stream. Each buffer is reused only
        # after the event recorded behind its last copy.
        self._on_cuda = device.type == "cuda"
        self._staging: List[Optional[torch.Tensor]] = [None] * N_STAGING
        self._staging_done: List[Optional[torch.cuda.Event]] = [None] * N_STAGING
        self._next_staging = 0
        self._table_pin = self._table_pin_done = None
        # host LRU cache of assembled rows, by bytes: evicted device rows
        # that come back (cyclic episode orders) skip re-assembly. With a
        # slot for every key no row is evicted, and none comes back.
        self._host_cache: "OrderedDict[Tuple[int, int], torch.Tensor]" = OrderedDict()
        self._host_cache_budget = HOST_CACHE_BYTES if self.capacity < n_keys else 0
        self._host_cache_bytes = 0
        self.rows_uploaded = 0
        self.bytes_uploaded = 0
        self.rows_assembled = 0
        self.host_s = {"rollout_inputs": 0.0, "prefetch": 0.0}
        self.prefetch_busy_returns = 0

    # -- host-side row assembly ------------------------------------------
    def _assemble_row(self, key: Tuple[int, int]) -> np.ndarray:
        scene_idx, src = key
        scene = self._scene_list[scene_idx]
        v = scene.num_nodes
        row = np.zeros((4, self._v_pad, self._rir_len, 2), np.float32)
        for az_i, az in enumerate(AZIMUTHS):
            row[az_i, :v] = self._audio_db.get_rir_block(scene.name, az, src, v)
        return row

    def _row_for(self, key: Tuple[int, int]) -> torch.Tensor:
        """The row of `key` in the slab's dtype, through the host LRU cache
        (a bfloat16 row is cast before it is cached: half the bytes)."""
        row = self._host_cache.get(key)
        if row is not None:
            self._host_cache.move_to_end(key)
            return row
        row = torch.from_numpy(self._assemble_row(key)).to(self.dtype)
        self.rows_assembled += 1
        if self._host_cache_budget > 0:
            self._host_cache[key] = row
            self._host_cache_bytes += self.row_bytes
            while self._host_cache_bytes > self._host_cache_budget:
                self._host_cache.popitem(last=False)
                self._host_cache_bytes -= self.row_bytes
        return row

    def _pinned(self, array, buf, done):
        """`array` (an ndarray or a CPU tensor) copied into the pinned
        buffer `buf` (made on first use), once the event `done` behind its
        last copy has passed."""
        src = torch.as_tensor(array)
        if buf is None:
            buf = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
        elif done is not None:
            done.synchronize()
        buf.copy_(src)
        return buf

    def _upload_row(self, slot: int, row: torch.Tensor) -> None:
        if not self._on_cuda:
            self._slab[slot].copy_(row)
            return
        i = self._next_staging
        self._next_staging = (i + 1) % len(self._staging)
        self._staging[i] = self._pinned(row, self._staging[i], self._staging_done[i])
        self._slab[slot].copy_(self._staging[i], non_blocking=True)
        self._staging_done[i] = torch.cuda.Event()
        self._staging_done[i].record()

    def _upload_table(self) -> None:
        if not self._on_cuda:
            self._table_dev.copy_(torch.from_numpy(self._table))
            return
        self._table_pin = self._pinned(self._table, self._table_pin, self._table_pin_done)
        self._table_dev.copy_(self._table_pin, non_blocking=True)
        self._table_pin_done = torch.cuda.Event()
        self._table_pin_done.record()

    def _keys_for(self, ep_ids: np.ndarray) -> List[Tuple[int, int]]:
        keys = []
        seen = set()
        for e in ep_ids:
            sc = int(self._ep_scene_idx[e])
            for s in self._ep_sources[e]:
                if s >= 0 and (sc, int(s)) not in seen:
                    seen.add((sc, int(s)))
                    keys.append((sc, int(s)))
        return keys

    def _future_rank(self) -> Dict[Tuple[int, int], int]:
        """The first window of use of each key over a lookahead that covers
        the capacity. The progression is deterministic, so eviction can take
        the key needed furthest in the future (Belady) where LRU would miss
        on every access of the cyclic orders the order table makes."""
        per_window = max(1, self._occ.order.shape[0] * self._ep_sources.shape[1])
        lookahead = min(64, 2 + self.capacity // per_window + 1)
        rank: Dict[Tuple[int, int], int] = {}
        for w, eps in enumerate(self._occ.episodes_by_window(lookahead, self._t_steps)):
            for k in self._keys_for(eps):
                rank.setdefault(k, w)
        return rank

    def _ensure(self, keys: List[Tuple[int, int]]) -> None:
        self._tick += 1
        needed = set(keys)
        missing = [k for k in keys if k not in self._key_to_slot]
        for k in keys:
            if k in self._key_to_slot:
                self._slot_tick[self._key_to_slot[k]] = self._tick
        if not missing:
            return
        if len(needed) > self.capacity:
            raise ValueError(
                f"sub-bank capacity {self.capacity} < {len(needed)} rows "
                "needed for one rollout window; raise TPU.SUB_BANK_ROWS"
            )
        future = self._future_rank()

        def evict_rank(i):
            # ascending = most evictable first: empty slots, then keys with
            # no use in the lookahead (oldest tick first), then keys by
            # descending next-use window (Belady)
            k = self._slot_key[i]
            if k is None:
                return (0, 0, 0)
            w = future.get(k)
            if w is None:
                return (1, 0, int(self._slot_tick[i]))
            return (2, -w, int(self._slot_tick[i]))

        free = sorted(
            (i for i in range(self.capacity)
             if self._slot_key[i] is None or self._slot_key[i] not in needed),
            key=evict_rank,
        )
        # one row at a time: each row's host assembly overlaps the previous
        # row's copy in flight
        for k, slot in zip(missing, free):
            slot = int(slot)
            old = self._slot_key[slot]
            if old is not None:
                del self._key_to_slot[old]
            self._slot_key[slot] = k
            self._key_to_slot[k] = slot
            self._slot_tick[slot] = self._tick
            row = self._row_for(k)
            self._upload_row(slot, row)
            self.rows_uploaded += 1
            self.bytes_uploaded += self.row_bytes

    # -- per-rollout API ---------------------------------------------------
    def rollout_inputs(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(slab, ep_src_row) covering the next ``t_steps`` window. Call it
        before each collect, then ``advance`` by the steps the collect ran."""
        t0 = time.perf_counter()
        eps = self._occ.episodes_for_window(self._t_steps)
        self._ensure(self._keys_for(eps))
        # every row of the window's episodes, each time: an episode whose
        # keys are all resident (it enters the window, or a key of it was
        # re-uploaded for another episode) may hold no row or a stale one
        changed = False
        for e in eps:
            sc = int(self._ep_scene_idx[e])
            for j, s in enumerate(self._ep_sources[e]):
                if s >= 0:
                    slot = self._key_to_slot[(sc, int(s))]
                    if self._table[e, j] != slot:
                        self._table[e, j] = slot
                        changed = True
        if changed:
            self._upload_table()
        self.host_s["rollout_inputs"] += time.perf_counter() - t0
        return self._slab, self._table_dev

    def prefetch(self) -> None:
        """Make the rows of the next window resident now. Called after a
        window's collect and update are queued: the row assembly overlaps
        them, and the slab writes run after them on the same stream, so the
        window they read is untouched. The next ``rollout_inputs`` then
        uploads no row."""
        t0 = time.perf_counter()
        if self._on_cuda:
            # behind the window's collect and update, ahead of this
            # prefetch's own copies
            queued = torch.cuda.Event()
            queued.record()
        self._ensure(self._keys_for(self._occ.episodes_for_window(self._t_steps)))
        self.host_s["prefetch"] += time.perf_counter() - t0
        if self._on_cuda and not queued.query():
            self.prefetch_busy_returns += 1

    def advance(self, t_steps: int) -> None:
        self._occ.advance(t_steps)

    def restore(self, cursor: np.ndarray, step: np.ndarray) -> None:
        """Set the episode mirror to a resumed device env's cursors and
        episode step counts."""
        self._occ.cursor = np.asarray(cursor, np.int64).copy()
        self._occ.step = np.asarray(step, np.int64).copy()
