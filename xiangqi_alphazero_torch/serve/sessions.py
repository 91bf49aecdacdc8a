"""Multi-session serving with coalesced batched search.

Port of ``xiangqi_alphazero_tpu.serve.sessions`` over this package's
predictor. The reference serves exactly one global game (reference:
demo/app.py:40-48) and coalesces single-state NN evaluations in a socket
inference server (reference: inference_server.py:163-249). Here each
concurrent game session that needs an AI reply enqueues its root position;
a collector thread gathers everything that arrives within the coalescing
window and runs ONE batched search over the batch, so the per-simulation
launch overhead on the card is shared by every active game.

Correctness: search lanes are numerically independent (no cross-lane
reductions; inference-mode batch norm), so a coalesced lane returns exactly
what a solo batch-1 search returns.

Requests are padded up to the next power-of-two bucket (<= max_batch), as
in the JAX package, so the card sees a handful of batch shapes.
"""

from __future__ import annotations

import secrets
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from ..engine.oracle import Position
from .predictor import Predictor


def _bucket(n: int, cap: int) -> int:
    b = 1
    while b < n and b < cap:
        b *= 2
    return min(b, cap)


class _Request:
    __slots__ = ("pos", "done", "result", "error")

    def __init__(self, pos: Position):
        self.pos = pos
        self.done = threading.Event()
        self.result: Optional[Tuple] = None
        self.error: Optional[BaseException] = None


class BatchedSearcher:
    """Coalesces concurrent AI-move searches into batched searches.

    The collector loop mirrors the reference inference server's request
    handling (reference: inference_server.py:163-249): block for the first
    request, keep collecting while more arrive inside ``window_ms``, stop
    early at ``max_batch``, run the batch, distribute per-lane results.
    Stats mirror its shutdown report (inference_server.py:282-286).
    """

    def __init__(
        self,
        predictor: Predictor,
        max_batch: int = 8,
        window_ms: float = 5.0,
        max_pending: int = 64,
    ):
        self.predictor = predictor
        self.max_batch = max(1, int(max_batch))
        self.window_s = float(window_ms) / 1000.0
        # backpressure: a stalled device must surface as a clean error to
        # new requests, not an unbounded pile of blocked server threads
        self.max_pending = max(1, int(max_pending))
        self._queue: deque[_Request] = deque()
        self._cv = threading.Condition()
        self._stopped = False
        self.num_batches = 0
        self.num_requests = 0
        self.batch_hist: Dict[int, int] = {}
        self._thread = threading.Thread(
            target=self._collector, name="batched-searcher", daemon=True
        )
        self._thread.start()

    # ------------------------------------------------------------- client
    def search(self, pos: Position) -> Tuple:
        """Blocking search request; returns (actions, visits, order,
        raw_policy, raw_value) for this position's lane of whatever batch
        it lands in — search and raw forward both coalesced. With the
        Gumbel search the lane's chosen action follows ``order``."""
        req = _Request(pos)
        with self._cv:
            if self._stopped:
                raise RuntimeError("searcher stopped")
            if len(self._queue) >= self.max_pending:
                raise RuntimeError(
                    f"searcher overloaded ({self.max_pending} pending)"
                )
            self._queue.append(req)
            self._cv.notify()
        req.done.wait()
        if req.error is not None:
            raise req.error
        return req.result

    def stop(self, drain_timeout: float = 120.0) -> None:
        """Stop accepting requests, let the collector finish everything
        already enqueued, then fail whatever is left only if the collector
        is genuinely wedged past ``drain_timeout``."""
        with self._cv:
            self._stopped = True
            self._cv.notify()
        self._thread.join(timeout=drain_timeout)
        if not self._thread.is_alive():
            return  # clean drain: the queue is empty by construction
        with self._cv:
            pending = list(self._queue)
            self._queue.clear()
        for req in pending:
            req.error = RuntimeError("searcher stopped")
            req.done.set()

    def stats(self) -> Dict:
        return {
            "batches": self.num_batches,
            "requests": self.num_requests,
            "mean_batch": round(
                self.num_requests / max(self.num_batches, 1), 3
            ),
            "batch_hist": dict(sorted(self.batch_hist.items())),
        }

    # ---------------------------------------------------------- collector
    def _collector(self) -> None:
        while True:
            with self._cv:
                while not self._queue and not self._stopped:
                    self._cv.wait()
                if self._stopped and not self._queue:
                    return
                # coalescing window: wait for stragglers (reference
                # batch_timeout_ms semantics) unless already full
                deadline = time.monotonic() + self.window_s
                while (
                    len(self._queue) < self.max_batch and not self._stopped
                ):
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cv.wait(timeout=remaining)
                batch = [
                    self._queue.popleft()
                    for _ in range(min(len(self._queue), self.max_batch))
                ]
            try:
                width = _bucket(len(batch), self.max_batch)
                positions = [r.pos for r in batch]
                results = self.predictor.search_batch(positions, pad_to=width)
                # the raw forward for every lane rides the same batch: one
                # search + one forward per round, not n single-state forwards
                raw_p, raw_v = self.predictor.raw_predict_batch(
                    positions, pad_to=width
                )
                for i, (req, res) in enumerate(zip(batch, results)):
                    req.result = res + (raw_p[i], float(raw_v[i]))
            except BaseException as e:  # noqa: BLE001 — delivered per-request
                for req in batch:
                    req.error = e
            finally:
                self.num_batches += 1
                self.num_requests += len(batch)
                self.batch_hist[len(batch)] = (
                    self.batch_hist.get(len(batch), 0) + 1
                )
                for req in batch:
                    req.done.set()

    def warmup(self, buckets: Optional[List[int]] = None) -> None:
        """Run every bucket's search + raw forward once (cuDNN picks its
        algorithms per batch shape on first use; the reference warms its
        server the same way, inference_server.py:101-107). By default every
        width a batch can take: the powers of 2 below ``max_batch`` and
        ``max_batch`` itself."""
        if buckets is None:
            buckets = sorted({_bucket(n, self.max_batch) for n in range(1, self.max_batch + 1)})
        for b in buckets:
            width = _bucket(b, self.max_batch)
            self.predictor.search_batch([Position()], pad_to=width)
            self.predictor.raw_predict_batch([Position()], pad_to=width)


class Session:
    __slots__ = ("sid", "pos", "human_side", "lock", "created", "last_active")

    def __init__(self, sid: str, human_side: int):
        self.sid = sid
        self.pos = Position()
        self.human_side = human_side
        self.lock = threading.Lock()
        self.created = time.time()
        self.last_active = self.created


class SessionManager:
    """Concurrent game sessions, LRU-evicted at ``max_sessions`` and
    expired after ``ttl_s`` idle (the reference has no sessions at all —
    one global game, demo/app.py:40-48)."""

    def __init__(self, max_sessions: int = 256, ttl_s: float = 3600.0):
        self.max_sessions = int(max_sessions)
        self.ttl_s = float(ttl_s)
        self._sessions: Dict[str, Session] = {}
        self._lock = threading.Lock()

    def create(self, human_side: int) -> Session:
        s = Session(secrets.token_hex(8), human_side)
        with self._lock:
            self._evict_locked()
            self._sessions[s.sid] = s
        return s

    def get(self, sid: str) -> Optional[Session]:
        with self._lock:
            s = self._sessions.get(sid)
            if s is None:
                return None
            if time.time() - s.last_active > self.ttl_s:
                del self._sessions[sid]
                return None
            s.last_active = time.time()
            return s

    def close(self, sid: str) -> bool:
        with self._lock:
            return self._sessions.pop(sid, None) is not None

    def count(self) -> int:
        with self._lock:
            return len(self._sessions)

    def _evict_locked(self) -> None:
        now = time.time()
        expired = [
            k for k, s in self._sessions.items()
            if now - s.last_active > self.ttl_s
        ]
        for k in expired:
            del self._sessions[k]
        while len(self._sessions) >= self.max_sessions:
            oldest = min(
                self._sessions.values(), key=lambda s: s.last_active
            )
            del self._sessions[oldest.sid]
