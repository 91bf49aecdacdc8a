"""Human-vs-AI REST API — dependency-free stdlib HTTP server.

Port of ``xiangqi_alphazero_tpu.serve.api`` over this package's predictor
and sessions, with the same endpoints and payloads. Endpoint-for-endpoint
parity with the reference Flask backend
(reference: demo/app.py:135-319): GET /api/models, POST /api/load_model,
POST /api/new_game, POST /api/human_move, POST /api/get_legal_moves,
GET /api/game_state, and / serving the static board UI. The global-game
endpoints keep the reference's single-game semantics (demo/app.py:40-48).

Beyond the reference: /api/session/* serves MANY concurrent games against
one loaded model, with every in-flight AI reply coalesced into one batched
search (serve/sessions.py). Session requests do NOT serialize on
the global lock — concurrency is the point; each session has its own lock
and the coalescing window turns simultaneous load into device batch.
Session games share the loaded model's simulation depth.

Implemented on http.server (Flask isn't a framework dependency); the handler
delegates to a plain ``GameService`` object that is also directly usable in
tests without sockets. It runs on the card unless it is given
``device="cpu"``, and reports the card's name as its device.
"""

from __future__ import annotations

import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple

from ..engine.oracle import Position, encode_action
from .predictor import Predictor, device_name, find_models, resolve_device
from .sessions import BatchedSearcher, SessionManager

_STATIC_DIR = os.path.join(os.path.dirname(__file__), "static")


class GameService:
    """The API's logic, transport-free."""

    def __init__(
        self,
        model_dirs: Optional[List[str]] = None,
        warm_sessions: bool = False,
        device=None,
        search_algo: str = "puct",
    ):
        self.model_dirs = model_dirs or ["models", "checkpoints"]
        self.device = resolve_device(device)
        # "puct" (reference semantics) or "gumbel" (sequential-halving
        # root, serve/predictor.py: stronger per simulation, so serving can
        # run far fewer simulations per move for the same strength)
        self.search_algo = search_algo
        self.predictor: Optional[Predictor] = None
        self.model_name: Optional[str] = None
        self.game: Optional[Position] = None
        self.human_side = 1
        self.num_simulations = 500
        self.lock = threading.Lock()
        # multi-session serving (beyond the reference's one global game)
        self.sessions = SessionManager()
        self.searcher: Optional[BatchedSearcher] = None
        self.search_batch_max = 8
        # run every coalescing bucket once at model load
        self.warm_sessions = warm_sessions
        # shutdown stats, like the reference inference server's req/s
        # report (inference_server.py:282-286). Counters use their own
        # lock: session handlers must never queue behind the global lock
        # (which load_model holds across its warmup).
        self.started = time.time()
        self.stats_lock = threading.Lock()
        self.requests = 0
        self.ai_moves = 0
        self.ai_time = 0.0

    # each method returns (status_code, payload)
    def models(self) -> Tuple[int, Dict]:
        return 200, {
            "models": find_models(self.model_dirs),
            "current": self.model_name,
            "device": device_name(self.device),
        }

    def load_model(self, data: Dict) -> Tuple[int, Dict]:
        name = data.get("model_name")
        found = [m for m in find_models(self.model_dirs) if m["name"] == name]
        if not found:
            return 404, {"error": f"model {name} not found"}
        # only a VALID load may change the serving depth — a 404 must not
        # leave a different depth behind for the next successful load
        if "num_simulations" in data:
            self.num_simulations = max(
                10, min(10000, int(data["num_simulations"]))
            )
        try:
            # build + warm the new predictor/searcher fully BEFORE
            # publishing either, so a failure leaves the old pair intact
            # and the two can never disagree about the model
            predictor = Predictor.load(
                found[0]["path"], num_simulations=self.num_simulations,
                algo=self.search_algo, device=self.device,
            )
            # run forward + search now, not on the first human move
            # (reference server warmup: inference_server.py:101-107)
            predictor.warmup()
            searcher = BatchedSearcher(
                predictor, max_batch=self.search_batch_max
            )
            if self.warm_sessions:
                searcher.warmup()
            # publish, then let in-flight session requests finish on the
            # old searcher before it stops
            old = self.searcher
            self.predictor, self.searcher = predictor, searcher
            self.model_name = name
            if old is not None:
                old.stop()
            return 200, {
                "success": True, "model_name": name,
                "device": device_name(self.device),
            }
        except Exception as e:  # noqa: BLE001 — surfaced to the client
            return 500, {"error": str(e)}

    def new_game(self, data: Dict) -> Tuple[int, Dict]:
        self.human_side = 1 if data.get("human_side", "red") == "red" else -1
        sims = int(data.get("num_simulations", 500))
        self.num_simulations = max(10, min(10000, sims))
        if (
            self.predictor is not None
            and self.predictor.num_simulations != self.num_simulations
        ):
            # a depth-clone shares the net — the session searcher keeps the
            # predictor it was built with, so live sessions never change
            # depth because the GLOBAL game picked a different one
            self.predictor = self.predictor.with_simulations(
                self.num_simulations
            )
        self.game = Position()
        result = {
            "board": self.game.board_array().reshape(10, 9).tolist(),
            "current_player": self.game.side,
            "human_side": self.human_side,
            "game_over": False,
            "winner": None,
            "ai_analysis": None,
        }
        if self.human_side == -1 and self.predictor is not None:
            result.update(self._timed_ai_move())
        return 200, result

    def human_move(self, data: Dict) -> Tuple[int, Dict]:
        if self.game is None:
            return 400, {"error": "no active game"}
        if self.game.side != self.human_side:
            return 400, {"error": "not your turn"}
        a = encode_action(
            data["from_row"], data["from_col"], data["to_row"], data["to_col"]
        )
        if a not in self.game.legal_actions():
            return 400, {"error": "illegal move"}
        self.game.apply(a)
        done, winner = self.game.result()
        result = {
            "board": self.game.board_array().reshape(10, 9).tolist(),
            "current_player": self.game.side,
            "game_over": done,
            "winner": int(winner) if winner else None,
            "ai_analysis": None,
        }
        if not done and self.predictor is not None:
            result.update(self._timed_ai_move())
        return 200, result

    def _timed_ai_move(self) -> Dict:
        t0 = time.time()
        out = self.predictor.ai_move(self.game)
        with self.stats_lock:
            self.ai_moves += 1
            self.ai_time += time.time() - t0
        return out

    def stats_line(self) -> str:
        dt = max(time.time() - self.started, 1e-9)
        avg = self.ai_time / max(self.ai_moves, 1)
        line = (
            f"served {self.requests} requests in {dt:.0f}s "
            f"({self.requests / dt:.2f} req/s), {self.ai_moves} AI moves "
            f"(avg {avg:.2f}s, {self.num_simulations} sims)"
        )
        if self.searcher is not None and self.searcher.num_batches:
            st = self.searcher.stats()
            line += (
                f"; session search: {st['requests']} searches in "
                f"{st['batches']} device batches "
                f"(mean batch {st['mean_batch']})"
            )
        return line

    def get_legal_moves(self, data: Dict) -> Tuple[int, Dict]:
        if self.game is None:
            return 400, {"error": "no active game"}
        fr, fc = data["row"], data["col"]
        moves = [
            {"to_row": tr, "to_col": tc}
            for mfr, mfc, tr, tc in self.game.legal_moves()
            if (mfr, mfc) == (fr, fc)
        ]
        return 200, {"moves": moves}

    def game_state(self) -> Tuple[int, Dict]:
        if self.game is None:
            return 200, {"active": False}
        done, winner = self.game.result()
        return 200, {
            "active": True,
            "board": self.game.board_array().reshape(10, 9).tolist(),
            "current_player": self.game.side,
            "human_side": self.human_side,
            "game_over": done,
            "winner": int(winner) if winner else None,
            "move_count": self.game.ply,
        }

    # ------------------------------------------------------- session mode
    # Beyond the reference: concurrent games, AI replies coalesced into one
    # batched search (serve/sessions.py). These handlers run WITHOUT
    # the global lock — only the per-session lock — so simultaneous moves
    # from different sessions overlap inside the coalescing window.

    def _session_payload(self, s, extra: Optional[Dict] = None) -> Dict:
        done, winner = s.pos.result()
        out = {
            "session_id": s.sid,
            "board": s.pos.board_array().reshape(10, 9).tolist(),
            "current_player": s.pos.side,
            "human_side": s.human_side,
            "game_over": done,
            "winner": int(winner) if winner else None,
            "move_count": s.pos.ply,
        }
        if extra:
            out.update(extra)
        return out

    def _session_ai_reply(self, s, searcher: BatchedSearcher) -> Dict:
        # searcher.predictor, not self.predictor: a concurrent load_model /
        # new_game may swap self.predictor mid-request, and the reply's
        # analysis must come from the same model that ran the search
        t0 = time.time()
        *search, raw_p, raw_v = searcher.search(s.pos.copy())
        out = searcher.predictor.ai_move_from_search(
            s.pos, tuple(search), raw=(raw_p, raw_v)
        )
        with self.stats_lock:
            self.ai_moves += 1
            self.ai_time += time.time() - t0
        return out

    def session_new(self, data: Dict) -> Tuple[int, Dict]:
        searcher = self.searcher
        if searcher is None:
            return 400, {"error": "no model loaded"}
        human_side = 1 if data.get("human_side", "red") == "red" else -1
        s = self.sessions.create(human_side)
        with s.lock:
            result = self._session_payload(s, {"ai_analysis": None})
            if human_side == -1:
                try:
                    result.update(self._session_ai_reply(s, searcher))
                except Exception as e:  # noqa: BLE001 — device/searcher
                    self.sessions.close(s.sid)
                    return 503, {"error": f"AI reply failed: {e}"}
                result["session_id"] = s.sid
                result["move_count"] = s.pos.ply
        return 200, result

    def session_move(self, data: Dict) -> Tuple[int, Dict]:
        searcher = self.searcher
        s = self.sessions.get(str(data.get("session_id")))
        if s is None:
            return 404, {"error": "no such session (expired or closed)"}
        if searcher is None:
            return 400, {"error": "no model loaded"}
        with s.lock:
            if s.pos.side != s.human_side:
                return 400, {"error": "not your turn"}
            a = encode_action(
                data["from_row"], data["from_col"],
                data["to_row"], data["to_col"],
            )
            if a not in s.pos.legal_actions():
                return 400, {"error": "illegal move"}
            before = s.pos.copy()
            s.pos.apply(a)
            done, _ = s.pos.result()
            result = self._session_payload(s, {"ai_analysis": None})
            if not done:
                try:
                    result.update(self._session_ai_reply(s, searcher))
                except Exception as e:  # noqa: BLE001 — device/searcher
                    # roll the human move back so the game stays playable
                    # (otherwise side-to-move is stuck at the AI forever)
                    s.pos = before
                    return 503, {"error": f"AI reply failed: {e}"}
                result["session_id"] = s.sid
                result["move_count"] = s.pos.ply
        return 200, result

    def session_legal_moves(self, data: Dict) -> Tuple[int, Dict]:
        s = self.sessions.get(str(data.get("session_id")))
        if s is None:
            return 404, {"error": "no such session (expired or closed)"}
        fr, fc = data["row"], data["col"]
        with s.lock:
            moves = [
                {"to_row": tr, "to_col": tc}
                for mfr, mfc, tr, tc in s.pos.legal_moves()
                if (mfr, mfc) == (fr, fc)
            ]
        return 200, {"moves": moves}

    def session_state(self, data: Dict) -> Tuple[int, Dict]:
        s = self.sessions.get(str(data.get("session_id")))
        if s is None:
            return 404, {"error": "no such session (expired or closed)"}
        with s.lock:
            return 200, self._session_payload(s)

    def session_close(self, data: Dict) -> Tuple[int, Dict]:
        ok = self.sessions.close(str(data.get("session_id")))
        return (200, {"closed": True}) if ok else (
            404, {"error": "no such session (expired or closed)"}
        )

    def session_stats(self) -> Tuple[int, Dict]:
        searcher = self.searcher
        return 200, {
            "active_sessions": self.sessions.count(),
            "search": searcher.stats() if searcher else None,
        }


def make_handler(service: GameService):
    routes_post = {
        "/api/load_model": service.load_model,
        "/api/new_game": service.new_game,
        "/api/human_move": service.human_move,
        "/api/get_legal_moves": service.get_legal_moves,
    }
    # session routes run OUTSIDE the global lock (per-session locks inside)
    # so concurrent games' searches can coalesce — see module docstring
    routes_session = {
        "/api/session/new": service.session_new,
        "/api/session/move": service.session_move,
        "/api/session/legal_moves": service.session_legal_moves,
        "/api/session/state": service.session_state,
        "/api/session/close": service.session_close,
    }

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload: Dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802
            # compute under the lock, WRITE outside it: a stalled client
            # socket must not block every other request on the lock
            if self.path == "/api/models":
                with service.stats_lock:  # GET APIs count in the stats too
                    service.requests += 1
                # lock-free: reads only the fs listing and the current
                # model name, and must stay responsive while load_model
                # holds the global lock across its warmup (the UI polls
                # this endpoint for its picker)
                self._send(*service.models())
            elif self.path == "/api/game_state":
                with service.stats_lock:
                    service.requests += 1
                with service.lock:
                    out = service.game_state()
                self._send(*out)
            elif self.path == "/api/session/stats":
                with service.stats_lock:
                    service.requests += 1
                self._send(*service.session_stats())
            elif self.path == "/" or self.path == "/app" or (
                self.path.endswith((".html", ".js", ".css"))
            ):
                name = {
                    "/": "index.html",
                    "/app": "app/index.html",
                }.get(self.path, self.path[1:])
                # containment check: resolved path must stay in static/
                full = os.path.realpath(os.path.join(_STATIC_DIR, name))
                if not full.startswith(os.path.realpath(_STATIC_DIR) + os.sep):
                    self._send(404, {"error": "no such asset"})
                    return
                ctype = {
                    ".html": "text/html; charset=utf-8",
                    ".js": "text/javascript; charset=utf-8",
                    ".css": "text/css; charset=utf-8",
                }[os.path.splitext(full)[1]]
                try:
                    with open(full, "rb") as f:
                        body = f.read()
                    self.send_response(200)
                    self.send_header("Content-Type", ctype)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                except (FileNotFoundError, IsADirectoryError):
                    self._send(404, {"error": "no such asset"})
            else:
                self._send(404, {"error": "not found"})

        def do_POST(self):  # noqa: N802
            session_fn = routes_session.get(self.path)
            fn = session_fn or routes_post.get(self.path)
            if fn is None:
                self._send(404, {"error": "not found"})
                return
            n = int(self.headers.get("Content-Length", 0))
            try:
                data = json.loads(self.rfile.read(n) or b"{}")
            except ValueError:
                self._send(400, {"error": "invalid JSON body"})
                return
            try:
                with service.stats_lock:
                    service.requests += 1
                if session_fn is not None:
                    out = fn(data)  # concurrent by design
                else:
                    with service.lock:
                        out = fn(data)
                self._send(*out)
            except (KeyError, TypeError, ValueError) as e:
                self._send(400, {"error": f"bad request: {e!r}"})
            except Exception as e:  # noqa: BLE001 — JSON, never a dropped
                self._send(500, {"error": f"internal error: {e!r}"})  # conn

        def log_message(self, fmt, *args):  # quiet
            pass

    return Handler


def make_server(host: str = "127.0.0.1", port: int = 5000,
                model_dirs: Optional[List[str]] = None,
                warm_sessions: bool = False,
                device=None,
                search_algo: str = "puct") -> Tuple[ThreadingHTTPServer, GameService]:
    """The HTTP server and its service, bound but not yet serving
    (``port=0`` binds a free port: ``httpd.server_address``)."""
    service = GameService(model_dirs, warm_sessions=warm_sessions, device=device,
                          search_algo=search_algo)
    httpd = ThreadingHTTPServer((host, port), make_handler(service))
    return httpd, service


def serve(host: str = "127.0.0.1", port: int = 5000,
          model_dirs: Optional[List[str]] = None,
          warm_sessions: bool = False,
          device=None,
          search_algo: str = "puct") -> None:
    httpd, service = make_server(host, port, model_dirs, warm_sessions, device,
                                 search_algo)
    print(f"xiangqi-az demo API on http://{host}:{port} "
          f"({device_name(service.device)}, {search_algo} search)")
    try:
        httpd.serve_forever()
    finally:
        # shutdown throughput report (reference: inference_server.py:282-286)
        print(service.stats_line())
