"""Host-side experience replay ring buffer with compact samples.

Port of ``xiangqi_alphazero_tpu.train.replay`` (numpy only, on the port's
own ``engine/tables.py``). The one difference: ``epoch_plan`` returns the
real steps only; the JAX package pads its plan to a capacity-derived length
so that XLA compiles the scan once, and skips the padding steps.

Both replace the reference's deque of dense (state 15x10x9 f32, pi 8100
f32, z) tuples (reference: train.py:114-129, 203) with a compact layout: samples
store the raw int8 board + side (91 bytes) and the search policy as sparse
(action, probability) slot pairs. Dense NN features and dense policy targets
are reconstructed on the device inside the train step — ~60x less host
memory and host->device traffic per sample.

Mirror augmentation (reference: train.py:132-151) happens at insert time via
the precomputed square/action permutations, doubling samples exactly like
the reference.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np

from ..engine import tables as _tables


class ReplayBuffer:
    def __init__(self, capacity: int, max_children: int = 128):
        self.capacity = capacity
        self.k = max_children
        self.boards = np.zeros((capacity, 90), np.int8)
        self.sides = np.zeros((capacity,), np.int8)
        self.pi_actions = np.full((capacity, max_children), -1, np.int32)
        self.pi_probs = np.zeros((capacity, max_children), np.float32)
        self.values = np.zeros((capacity,), np.float32)
        self.size = 0
        self._pos = 0
        t = _tables.tables()
        self._mirror_sq = t["MIRROR_SQ"]
        self._mirror_act = t["MIRROR_ACT"]

    def __len__(self) -> int:
        return self.size

    def _insert(self, boards, sides, pi_actions, pi_probs, values) -> None:
        n = boards.shape[0]
        idx = (self._pos + np.arange(n)) % self.capacity
        self.boards[idx] = boards
        self.sides[idx] = sides
        self.pi_actions[idx] = pi_actions
        self.pi_probs[idx] = pi_probs
        self.values[idx] = values
        self._pos = int((self._pos + n) % self.capacity)
        self.size = int(min(self.size + n, self.capacity))

    def add_games(self, boards, sides, pi_actions, pi_probs, values,
                  augment: bool = True) -> int:
        """Insert flat sample arrays; optionally also their mirror images.
        Returns number of samples inserted."""
        boards = np.asarray(boards, np.int8)
        sides = np.asarray(sides, np.int8)
        pi_actions = np.asarray(pi_actions, np.int32)
        pi_probs = np.asarray(pi_probs, np.float32)
        values = np.asarray(values, np.float32)
        self._insert(boards, sides, pi_actions, pi_probs, values)
        n = boards.shape[0]
        if augment:
            m_boards = boards[:, self._mirror_sq]
            m_actions = np.where(
                pi_actions >= 0, self._mirror_act[np.maximum(pi_actions, 0)], -1
            ).astype(np.int32)
            self._insert(m_boards, sides, m_actions, pi_probs, values)
            n *= 2
        return n

    def state_dict(self) -> dict:
        """Full ring state (storage arrays + cursor) for checkpointing.
        The reference does NOT checkpoint its replay deque (reference:
        train.py:537-554) — resuming there always restarts from a cold
        buffer at an LR-schedule position the original run reached with a
        full one (measured to stall continuation training; see
        models/README.md). Saving the ring makes resume bit-exact."""
        return {
            "boards": self.boards,
            "sides": self.sides,
            "pi_actions": self.pi_actions,
            "pi_probs": self.pi_probs,
            "values": self.values,
            "size": np.int64(self.size),
            "pos": np.int64(self._pos),
        }

    def load_state(self, state) -> None:
        """Restore a ``state_dict``. A capacity change re-inserts the valid
        samples oldest-first so a smaller ring keeps the NEWEST ones (the
        same samples the old ring would have kept); mirror augmentation is
        not reapplied (the saved rows already include the mirrors)."""
        src_k = state["pi_actions"].shape[1]
        if src_k != self.k:
            raise ValueError(
                f"replay slot width mismatch: checkpoint k={src_k}, "
                f"buffer k={self.k} (max_children changed)"
            )
        src_cap = state["boards"].shape[0]
        size, pos = int(state["size"]), int(state["pos"])
        if src_cap == self.capacity:
            for name in ("boards", "sides", "pi_actions", "pi_probs",
                         "values"):
                getattr(self, name)[:] = state[name]
            self.size, self._pos = size, pos
            return
        # chronological oldest -> newest, newest `capacity` rows kept
        order = (
            (pos + np.arange(size)) % src_cap if size == src_cap
            else np.arange(size)
        )[-self.capacity:]
        self.size = self._pos = 0
        self._insert(
            state["boards"][order],
            state["sides"][order],
            state["pi_actions"][order],
            state["pi_probs"][order],
            state["values"][order],
        )

    def arrays(self) -> Tuple[np.ndarray, ...]:
        """The FULL fixed-capacity storage arrays (only rows < len(self)
        are valid; index through an epoch_plan)."""
        return (self.boards, self.sides, self.pi_actions, self.pi_probs,
                self.values)

    def epoch_plan(
        self, batch_size: int, epochs: int, rng: np.random.Generator,
    ) -> Tuple[np.ndarray, np.ndarray, int]:
        """Index plan for all epochs' train steps: (perm i32[S, b], wmask
        f32[S, b], S). Shuffle semantics match epoch_batches (fresh
        permutation per epoch, final partial batch zero-weight padded with
        row 0). The draws and rows are the JAX package's; its plan adds
        all-zero-weight steps up to a capacity-derived length, which are
        left out here."""
        steps = -(-self.size // batch_size) * epochs
        perm = np.zeros((steps, batch_size), np.int32)
        wmask = np.zeros((steps, batch_size), np.float32)
        i = 0
        for _ in range(epochs):
            order = rng.permutation(self.size)
            for start in range(0, self.size, batch_size):
                idx = order[start : start + batch_size]
                perm[i, : idx.shape[0]] = idx
                wmask[i, : idx.shape[0]] = 1.0
                i += 1
        return perm, wmask, steps

    def epoch_batches(
        self, batch_size: int, rng: np.random.Generator
    ) -> Iterator[Tuple[np.ndarray, ...]]:
        """One shuffled pass over the whole buffer (reference DataLoader
        semantics, train.py:384-391: shuffle=True, drop_last=False). The
        final partial batch is padded to the batch shape with a weight mask."""
        order = rng.permutation(self.size)
        for start in range(0, self.size, batch_size):
            idx = order[start : start + batch_size]
            n = idx.shape[0]
            if n < batch_size:
                idx = np.concatenate(
                    [idx, np.zeros(batch_size - n, idx.dtype)]
                )
            w = np.zeros(batch_size, np.float32)
            w[:n] = 1.0
            yield (
                self.boards[idx],
                self.sides[idx],
                self.pi_actions[idx],
                self.pi_probs[idx],
                self.values[idx],
                w,
            )
