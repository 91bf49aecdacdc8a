"""Self-play: ``train/selfplay.py::selfplay_games``, a fleet of games in
lockstep, searched by the configuration's search at every ply.

Set-up makes the weights from the seed, builds the program's net in eval
mode and its evaluation function (``policy_logits_fn``, as the trainer
passes it), and warms every kernel at the fleet's shapes with one call of
one opening round and one ply. The window then makes whole calls, as the
trainer's self-play phase does, each to the configuration's move cap.

The evaluation function is wrapped by ``Recorder``, which counts the
positions evaluated and, at a few evaluations of each timed call drawn from
the seed, keeps some rows of the net's input and output for the check. It
also follows a few games of each call, drawn from the seed: at every
evaluation it keeps their rows and the generator's state, so that the
check can replay the search of some of their plies with the plain
reference (``reference/search.py``).
"""

from __future__ import annotations

import sys
import time
from typing import Dict, List

import numpy as np
import torch

from .. import inputs, program
from ..reference import float32_exact, resnet, rules, search


class Recorder:
    """The evaluation function as the program gets it, plus a count of the
    positions evaluated, copies of sampled rows, and the rows of the
    followed games with the generator's state at every evaluation (armed
    per call). With a ``window`` set, the first evaluation opens it."""

    def __init__(self, fn, batch: int, rows: int, rng: np.random.Generator, device,
                 gen: torch.Generator):
        self.fn, self.batch, self.rows, self.rng, self.device = fn, batch, rows, rng, device
        self.gen = gen
        self.positions = 0
        self.kept: List[tuple] = []
        self._due: set = set()
        self._n = 0
        self._idx = None
        self.lanes = None
        self.trail: List[tuple] = []
        self.first_at = None
        self.window = None

    def arm(self, evals: int, picks: int, lanes: np.ndarray) -> None:
        """Keep rows at ``picks`` of the next call's first ``evals``
        evaluations, and the rows of the games ``lanes`` at every one."""
        self._n = 0
        self._due = set(self.rng.choice(evals, size=min(picks, evals), replace=False).tolist())
        idx = self.rng.choice(self.batch, size=min(self.rows, self.batch), replace=False)
        self._idx = torch.as_tensor(np.sort(idx), device=self.device)
        self.lanes = torch.as_tensor(lanes, device=self.device)
        self.trail = []
        self.first_at = None

    def __call__(self, feats: torch.Tensor):
        if self.first_at is None:
            self.first_at = time.perf_counter()
        if self.window is not None:
            self.window.start()
        state = self.gen.get_state() if self.lanes is not None else None
        logits, value = self.fn(feats)
        self.positions += feats.shape[0]
        if feats.shape[0] == self.batch:
            if self._n in self._due:
                self.kept.append((feats[self._idx], logits[self._idx], value[self._idx]))
            if self.lanes is not None:
                self.trail.append((feats.index_select(0, self.lanes),
                                   logits.index_select(0, self.lanes),
                                   value.index_select(0, self.lanes), state))
        self._n += 1
        return logits, value


class SelfPlay:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.tr, self.seed = cfg, traffic, seed
        self.device = torch.device(device)
        self.rng = np.random.default_rng(seed)

    def _settings(self, **over):
        from xiangqi_alphazero_torch.train.selfplay import SelfPlaySettings

        keys = SelfPlaySettings._fields
        s = SelfPlaySettings(**{k: v for k, v in self.cfg.items() if k in keys})
        return s._replace(**over)

    def setup(self) -> None:
        from xiangqi_alphazero_torch.models.resnet import policy_logits_fn
        from xiangqi_alphazero_torch.train.selfplay import selfplay_games

        cfg, dev = self.cfg, self.device
        self.selfplay_games = selfplay_games
        w = inputs.net_weights(cfg["num_channels"], cfg["num_res_blocks"], self.seed, dev)
        self.w0 = {k: v.cpu() for k, v in w.items()}
        self.net = program.build_net(cfg, w, dev).eval()
        del w
        self.games = self.tr["games"]
        self.gen = torch.Generator().manual_seed(int(self.seed))
        self.ev = Recorder(policy_logits_fn(self.net), self.games, self.tr["eval_rows"],
                           self.rng, dev, self.gen)
        self.settings = self._settings()
        self.outs, self.trails = [], []
        # every kernel of a call, at the fleet's shapes: one opening round,
        # one ply of a two-simulation search
        self._call(self._settings(max_game_length=1, num_simulations=2,
                                  random_opening_moves=min(1, cfg["random_opening_moves"])))
        self.ev.positions = 0

    def _call(self, settings):
        """One call of ``selfplay_games``, waited for."""
        self.call_t0 = time.perf_counter()
        with torch.inference_mode():
            out = self.selfplay_games(self.ev, self.games, settings, self.gen, self.device,
                                      logits_eval=True)
        program.sync(self.device)
        return out

    def _recorded_call(self, settings):
        s = settings
        lanes = np.sort(self.rng.choice(self.games, size=min(self.tr["search_lanes"], self.games),
                                        replace=False))
        self.ev.arm(s.max_game_length * (s.num_simulations + 1), self.tr["evals_per_call"], lanes)
        out = self._call(settings)
        self.outs.append(out)
        self.trails.append((lanes, self.ev.trail, self.ev.first_at - self.call_t0))
        self.ev.trail = []
        return out

    # ------------------------------------------------------------ windows
    def window(self, seconds: float):
        sims = 0
        program.sync(self.device)
        t0 = time.perf_counter()
        calls = []
        while True:
            out = self._recorded_call(self.settings)
            sims += self.games * sum(out.sims_per_ply)
            calls.append(time.perf_counter())
            elapsed = time.perf_counter() - t0
            if elapsed >= seconds:
                break
        # per call, on standard error: its wall time, the host seconds
        # before its first evaluation (the openings), and the share of its
        # game-plies still alive (the rest are searched all the same)
        for i, (out, trail) in enumerate(zip(self.outs[-len(calls):], self.trails[-len(calls):])):
            wall = calls[i] - (calls[i - 1] if i else t0)
            alive = float(out.rec.sum()) / (self.games * len(out.sims_per_ply))
            print(f"call {i}: {wall:.4f} s, openings {trail[2]:.4f} s, "
                  f"alive game-plies {alive:.4f}", file=sys.stderr)
        return ({"selfplay_sims_per_s": sims / elapsed},
                {"sims": sims, "positions": self.ev.positions, "window_s": elapsed,
                 "attempted": self.games * len(self.outs)})

    def traced(self):
        """One call of ``trace_plies`` plies, traced from its first
        evaluation: the plies, without the host's opening draws."""
        from .. import tracing

        self.ev.window = tracing.Window(lambda: program.sync(self.device))
        out = self._recorded_call(self._settings(max_game_length=self.tr["trace_plies"]))
        trace, self.ev.window = self.ev.window.stop(), None
        return trace, {"games": self.games, "sim_steps": sum(out.sims_per_ply),
                       "positions": self.ev.positions, "attempted": self.games,
                       "openings_s": self.trails[-1][2]}

    def release(self) -> None:
        """Keep the sampled records on the host; free the program's state."""
        self.samples = [self._sample(out) for out in self.outs]
        self.evals = [tuple(x.float().cpu().numpy() for x in rec) for rec in self.ev.kept]
        self.followed = [self._followed(out, *trail) for out, trail in zip(self.outs, self.trails)]
        del self.net, self.ev, self.outs, self.trails
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _sample(self, out) -> Dict[str, np.ndarray]:
        """A sample drawn from the seed of the plies this call recorded that
        have a next ply recorded after them."""
        rec = out.rec.cpu().numpy()
        rec[-1] = False
        t, b = np.nonzero(rec)
        pick = self.rng.choice(len(t), size=min(self.tr["positions_per_call"], len(t)),
                               replace=False)
        t, b = torch.as_tensor(t[pick]), torch.as_tensor(b[pick])
        get = lambda x, dt=0: x[(t + dt).to(x.device), b.to(x.device)].cpu().numpy()  # noqa: E731
        return {"board": get(out.boards), "side": get(out.sides), "next": get(out.boards, 1),
                "next_side": get(out.sides, 1), "actions": get(out.pi_actions),
                "pi": get(out.pi_probs)}

    @staticmethod
    def _followed(out, lanes: np.ndarray, trail: List[tuple], _openings_s: float) -> dict:
        """The followed games' record and their rows at every evaluation,
        on the host."""
        ix = torch.as_tensor(lanes, device=out.boards.device)
        get = lambda x: x[:, ix].cpu().numpy()  # noqa: E731
        feats = torch.stack([t[0] for t in trail]).float().cpu().numpy()
        boards, sides = rules.decode_features(feats.reshape(-1, *feats.shape[2:]))
        return {"lanes": lanes, "plies": len(out.sims_per_ply), "boards": get(out.boards),
                "sides": get(out.sides), "actions": get(out.pi_actions), "pi": get(out.pi_probs),
                "rec": get(out.rec), "eval_boards": boards.reshape(len(trail), len(lanes), -1),
                "eval_sides": sides.reshape(len(trail), len(lanes)),
                "logits": torch.stack([t[1] for t in trail]).cpu(),
                "values": torch.stack([t[2] for t in trail]).float().cpu().numpy(),
                "states": [t[3] for t in trail]}

    # -------------------------------------------------------------- check
    def _exact_counts(self) -> Dict[str, float]:
        """Counts of sampled plies whose legal set, move or policy target is
        wrong by the reference's rules."""
        cfg = self.cfg
        sims = cfg["num_simulations"]
        visit_counts = (cfg["search_algo"] == "puct"
                        and cfg["temperature_threshold"] >= cfg["max_game_length"])
        bad_legal = bad_step = bad_pi = 0
        for s in self.samples:
            for i in range(len(s["board"])):
                board, side = s["board"][i], int(s["side"][i])
                acts, pi = s["actions"][i], s["pi"][i].astype(np.float64)
                legal = rules.legal_actions(board, side)
                valid = acts >= 0
                if sorted(acts[valid].tolist()) != legal:
                    bad_legal += 1
                nxt = s["next"][i].tolist()
                played = [a for a in legal if rules.apply(board, a) == nxt]
                if (len(played) != 1 or int(s["next_side"][i]) != -side
                        or not (pi[valid][acts[valid] == played[0]] > 0).all()):
                    bad_step += 1
                ok = ((pi >= 0).all() and (pi[~valid] == 0).all()
                      and abs(pi.sum() - 1.0) <= 1e-4)
                if ok and visit_counts:
                    n = pi * sims
                    ok = bool(np.abs(n - np.round(n)).max() <= 1e-3 and round(n.sum()) == sims)
                bad_pi += not ok
        return {"legal_mismatch": bad_legal, "step_mismatch": bad_step, "pi_mismatch": bad_pi}

    def _eval_gaps(self, quant=None) -> Dict[str, float]:
        """Gaps between the net's outputs at the recorded evaluations and
        the reference's forward from the seed's weights at the positions
        they encode: the widest log-prior gap over each position's legal
        moves, and the widest value gap. With ``quant`` the control's
        forward takes the program's place."""
        dev = self.device
        params = {k: v.to(dev, copy=True) for k, v in self.w0.items()}
        bad_input, pol, val = 0, 0.0, 0.0
        for feats, logits, value in self.evals:
            boards, sides = rules.decode_features(feats)
            bt, st = torch.as_tensor(boards), torch.as_tensor(sides)
            ref_feats = rules.features(bt, st)
            bad_input += int((ref_feats.numpy() != feats).reshape(len(feats), -1).any(1).sum())
            with torch.no_grad():
                r_logits, r_value = resnet.forward(params, ref_feats.to(dev), False)
                if quant is not None:
                    logits, value = (x.cpu().numpy() for x in
                                     resnet.forward(params, ref_feats.to(dev), False, quant))
            r_logits, r_value = r_logits.cpu().numpy(), r_value.cpu().numpy()
            val = max(val, float(np.abs(value - r_value).max()))
            for i in range(len(boards)):
                legal = rules.legal_actions(boards[i], int(sides[i]))
                if legal:
                    a = torch.as_tensor(legal)
                    p = torch.log_softmax(torch.as_tensor(logits[i], dtype=torch.float64)[a], 0)
                    r = torch.log_softmax(torch.as_tensor(r_logits[i], dtype=torch.float64)[a], 0)
                    pol = max(pol, float((p - r).abs().max()))
        return {"input_mismatch": bad_input, "policy_gap": pol, "value_gap": val}

    def _replay(self, rec: dict, j: int, t: int) -> search.Replay:
        """The search of game ``j``'s ply ``t`` replayed by the reference,
        from the program's evaluation of that root (found by its position,
        the one that its search's first leaf follows)."""
        sims = self.cfg["num_simulations"]
        board, side = rec["boards"][t, j], int(rec["sides"][t, j])
        eb, es = rec["eval_boards"][:, j], rec["eval_sides"][:, j]
        at_root = (eb == board).all(axis=1) & (es == side)
        n_eval = len(at_root)
        nxt = rec["boards"][t + 1, j].tolist()
        played = [a for a in rules.legal_actions(board, side) if rules.apply(board, a) == nxt]
        best = None
        for e in np.nonzero(at_root)[0]:
            if e + sims >= n_eval or at_root[e + 1]:
                continue

            def evals(k, e=e):
                return (tuple(eb[e + k].tolist()), int(es[e + k]),
                        rec["logits"][e + k, j].float().numpy(), float(rec["values"][e + k, j]))

            r = search.replay(self.cfg, board, side, rec["boards"][:t, j], rec["actions"][t, j],
                              (rec["states"][e], self.games, int(rec["lanes"][j])), evals,
                              rec["pi"][t, j], played[0] if len(played) == 1 else None)
            if r.ok or r.skipped:
                return r
            if best is None or r.sims > best.sims:
                best = r
        return best or search.Replay(False, why="no evaluation of the root before its search")

    def _search_counts(self) -> Dict[str, float]:
        """Roots whose search the reference replays to another result: for
        each call, ``search_roots_per_call`` of its followed games, at a ply
        drawn from the seed among those where the game was alive and the
        next ply was played."""
        cfg = self.cfg
        if cfg["search_algo"] == "puct" and cfg["temperature_threshold"] < cfg["max_game_length"]:
            raise SystemExit("the PUCT search check reads visit counts: temperature 1 at every ply")
        n = bad = skipped = ties = 0
        gap = 0.0
        for rec in self.followed:
            done = 0
            for j in self.rng.permutation(len(rec["lanes"])):
                alive = np.nonzero(rec["rec"][: rec["plies"] - 1, j])[0]
                if done == self.tr["search_roots_per_call"] or not len(alive):
                    continue
                r = self._replay(rec, int(j), int(self.rng.choice(alive)))
                done += 1
                n, ties, gap = n + 1, ties + r.ties, max(gap, r.pi_gap)
                skipped += r.skipped
                if not (r.ok or r.skipped):
                    bad += 1
                    print(f"search replay: game {rec['lanes'][j]}: {r.why}", file=sys.stderr)
        return {"search_mismatch": bad, "search_roots": n, "search_skipped": skipped,
                "search_ties": ties, "search_pi_gap": gap}

    def check(self) -> Dict[str, float]:
        with float32_exact():
            return {**self._exact_counts(), **self._eval_gaps(), **self._search_counts()}

    def calibrate(self) -> Dict[str, Dict[str, float]]:
        with float32_exact():
            return {"program": {**self._exact_counts(), **self._eval_gaps(),
                                **self._search_counts()},
                    "control": self._eval_gaps(quant=resnet.fp8_round)}


Driver = SelfPlay
