"""Plain PUCT and Gumbel searches of one root, replayed beside the program's.

The program searches a whole fleet at once over batched trees. Here one
game's search is written out plainly, one node object a position: PUCT
after the public reference (wenjunyang/xiangqi-alphazero, training/mcts.py:
select Q + c_puct * P * sqrt(N_parent) / (1 + N), Q = W / N and 0 where
unvisited, Dirichlet noise on the root's priors, terminal value 1 for a
decisive end and 0 for a draw, the net's value negated once and the sign
alternating up the path); Gumbel after Danihelka et al., "Policy
improvement by planning with Gumbel" (ICLR 2022) as mctx runs it: top-m
root candidates by g + logits, sequential halving by g + logits + sigma(Q),
sigma(q) = (c_visit + max N) * c_scale * q over the completed Q, the
interior rule argmax pi'(a) - N(a) / (1 + sum N), and the improved policy
pi' = softmax(logits + sigma(completed Q)) as the target.

What a search reads from outside it is taken as given: the net's outputs
at each position the program evaluated (held against the plain net by
themselves), the root's random draw (made again here from the generator's
state at the root's evaluation), and which slot of the draw belongs to
which move (the order of the program's recorded slots). Everything else is
worked out here: legal moves and terminal states (``rules.py``), priors
from the logits, each descent, backup, Q and visit count, the halving, the
acted move and the target. Each simulation's leaf has to be the position
the program evaluated next. Where children's scores lie within ``TOL`` of
the best (float rounding, or an exact tie that the program breaks by its
move order), the replay follows the one whose leaf the program evaluated.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import rules

TOL = 1e-4        # score gaps under this count as ties (float32 rounding is ~1e-6)
HIST_LEN = 12     # a position's repetition window: the 12 boards before it
MAX_PATHS = 10000


@dataclasses.dataclass
class Replay:
    ok: bool
    skipped: bool = False   # undecidable by float rounding: not judged
    ties: int = 0           # near-ties the replay followed the program through
    pi_gap: float = 0.0     # widest gap between the program's target and the replay's
    sims: int = 0           # simulations replayed
    why: str = ""


class Node:
    __slots__ = ("board", "side", "line", "terminal", "t_val", "value", "actions", "prior",
                 "n", "w", "child")

    def __init__(self, board: tuple, side: int, line: tuple):
        self.board, self.side, self.line = board, side, line
        legal = rules.legal_actions(board, side)
        self.actions = np.asarray(legal, dtype=np.int64)
        # the side to move has no move and loses; a fourth occurrence draws
        rep = sum(1 for b in line[-HIST_LEN:] if b == board) >= 3
        self.terminal = not legal or rep
        self.t_val = 1.0 if not legal else 0.0
        self.value = 0.0
        self.prior = self.n = self.w = None
        self.child: List[Optional[Node]] = []

    def expand(self, logits: np.ndarray, value: float, order: Optional[Sequence[int]] = None):
        """Priors: the softmax of the logits over the legal moves (in
        ``order``, the root's slot order, where given)."""
        if order is not None:
            self.actions = np.asarray(order, dtype=np.int64)
        lg = logits[self.actions].astype(np.float64)
        p = np.exp(lg - lg.max())
        self.prior = p / p.sum()
        self.value = float(value)
        self.n = np.zeros(len(self.actions))
        self.w = np.zeros(len(self.actions))
        self.child = [None] * len(self.actions)

    def after(self, i: int) -> Tuple[tuple, int]:
        return tuple(rules.apply(self.board, int(self.actions[i]))), -self.side


def _softmax(x: np.ndarray) -> np.ndarray:
    e = np.exp(x - x.max())
    return e / e.sum()


def completed_q(node: Node) -> np.ndarray:
    """Q of every child, the unvisited ones filled with the value mix
    (v + sum N * prior-weighted visited Q) / (1 + sum N)."""
    seen = node.n > 0
    q = np.where(seen, node.w / np.maximum(node.n, 1), 0.0)
    sum_n = node.n.sum()
    pv = np.where(seen, node.prior, 0.0)
    wq = (pv * q).sum() / max(pv.sum(), 1e-12)
    mix = (node.value + sum_n * wq) / (1.0 + sum_n) if sum_n > 0 else node.value
    return np.where(seen, q, mix)


def halving_schedule(budget: int, m: int) -> List[Tuple[int, int]]:
    """[(candidates, simulations)] of each phase of sequential halving:
    ceil(log2 m) phases of budget // (phases * m_p) visits a candidate, the
    leftover as one more halved phase."""
    phases = max(1, math.ceil(math.log2(m))) if m > 1 else 1
    segs, left, m_p = [], budget, m
    for _ in range(phases):
        if left <= 0:
            break
        cnt = min(max(1, budget // (phases * m_p)) * m_p, left)
        segs.append((m_p, cnt))
        left -= cnt
        m_p = max(1, m_p // 2)
    if left > 0:
        segs.append((max(1, segs[-1][0] // 2), left))
    return segs or [(m, 0)]


class Search:
    """One root's search, fed the program's evaluations one at a time."""

    def __init__(self, cfg: dict, evals: Callable[[int], Tuple[tuple, int, np.ndarray, float]]):
        self.cfg, self.evals = cfg, evals
        self.gumbel = cfg["search_algo"] == "gumbel"
        sims = cfg["num_simulations"]
        self.max_depth = max(1, sims) if self.gumbel else sims + 2
        self.ties = 0
        self.root_n = 0

    # ---------------------------------------------------------- scores
    def scores(self, node: Node, node_n: float) -> np.ndarray:
        if self.gumbel:
            c = self.cfg
            sig = (c["c_visit"] + node.n.max()) * c["c_scale"] * completed_q(node)
            pi2 = _softmax(np.log(np.maximum(node.prior, 1e-30)) + sig)
            return pi2 - node.n / (1.0 + node.n.sum())
        q = np.where(node.n > 0, node.w / np.maximum(node.n, 1), 0.0)
        return q + self.cfg["c_puct"] * node.prior * math.sqrt(node_n) / (1.0 + node.n)

    def paths(self, node: Node, node_n: float, depth: int,
              forced: Optional[int] = None) -> Iterator[list]:
        """Every descent the rule allows from ``node``, the best first: a
        list of (node, child index) to a new child or a terminal one."""
        if forced is not None:
            order = [forced]
        else:
            s = self.scores(node, node_n)
            near = np.nonzero(s >= s.max() - TOL)[0]
            order = near[np.argsort(-s[near], kind="stable")]
        for i in order:
            ch = node.child[i]
            if ch is None or ch.terminal or depth + 1 >= self.max_depth:
                yield [(node, int(i))]
            else:
                for rest in self.paths(ch, node.n[i], depth + 1):
                    yield [(node, int(i))] + rest

    # ------------------------------------------------------ simulation
    def simulate(self, root: Node, k: int, forced: Optional[int] = None) -> Optional[str]:
        """Simulation ``k`` (1-based): the descent whose leaf the program
        evaluated at its k-th evaluation after the root's, its expansion and
        backup. Returns why it failed, or None."""
        board, side, logits, value = self.evals(k)
        found = None
        for tried, path in enumerate(self.paths(root, self.root_n, 0, forced)):
            node, i = path[-1]
            ch = node.child[i]
            leaf = (ch.board, ch.side) if ch is not None else node.after(i)
            if leaf == (board, side):
                found = path
            if found or tried + 1 >= MAX_PATHS:
                break
        if found is None:
            return f"simulation {k}: the program evaluated a position no descent reaches"
        path = found
        self.ties += tried > 0
        if ch is None:
            ch = Node(board, side, (node.line + (node.board,))[-HIST_LEN:])
            if not ch.terminal:
                ch.expand(logits, value)
            node.child[i] = ch
            v = ch.t_val if ch.terminal else -float(value)
        elif ch.terminal:
            v = ch.t_val
        else:
            return "skip: a descent reached the depth cap"
        for d, (nd, j) in enumerate(reversed(path)):
            nd.n[j] += 1
            nd.w[j] += v if d % 2 == 0 else -v
        self.root_n += 1
        return None


def replay(cfg: dict, root_board: Sequence[int], root_side: int, line: Sequence[Sequence[int]],
           slots: np.ndarray, draw: Tuple[torch.Tensor, int, int],
           evals: Callable[[int], Tuple[tuple, int, np.ndarray, float]],
           pi: np.ndarray, played: Optional[int]) -> Replay:
    """Replay one root's search and compare its result with the program's.

    ``line``: the game's boards before the root (what the record holds);
    ``slots``: the program's slot actions at the root (-1 pads);
    ``draw``: (the generator's state at the root's evaluation, fleet size,
    this game's row); ``evals(k)``: (board, side, logits, value) of the
    program's k-th evaluation from the root's (0); ``pi``: the program's
    target by slot; ``played``: the move it played."""
    sims = cfg["num_simulations"]
    k_slots = len(slots)
    board, side, logits, value = evals(0)
    root = Node(tuple(int(x) for x in root_board), int(root_side),
                tuple(tuple(int(x) for x in b) for b in line)[-HIST_LEN:])
    if (root.board, root.side) != (board, side) or root.terminal:
        return Replay(False, why="the root's evaluation is of another position")
    valid = np.nonzero(slots >= 0)[0]
    if sorted(slots[valid].tolist()) != root.actions.tolist():
        return Replay(False, why="the root's slots are not its legal moves")
    root.expand(logits, value, order=slots[valid])
    state, fleet, row = draw
    gen = torch.Generator()
    gen.set_state(state)
    search = Search(cfg, evals)
    if search.gumbel:
        u = torch.rand((fleet, k_slots), generator=gen)[row]
        g = (-torch.log(-torch.log(u.clamp(min=1e-20))))[valid].double().numpy()
        return _gumbel(search, root, g, pi[valid], played)
    conc = torch.full((fleet, k_slots), cfg["dirichlet_alpha"], dtype=torch.float32)
    gam = torch._standard_gamma(conc, generator=gen)[row][valid].double().numpy()
    eps = cfg["noise_frac"]
    root.prior = (1.0 - eps) * root.prior + eps * gam / max(gam.sum(), 1e-30)
    for k in range(1, sims + 1):
        why = search.simulate(root, k)
        if why:
            return Replay(False, skipped=why.startswith("skip"), ties=search.ties, sims=k, why=why)
    got = root.n / max(root.n.sum(), 1.0)
    gap = float(np.abs(pi[valid].astype(np.float64) - got).max())
    same = np.array_equal(np.round(pi[valid].astype(np.float64) * root.n.sum()), root.n)
    return Replay(same and abs(pi.sum() - 1.0) <= 1e-4, ties=search.ties, pi_gap=gap, sims=sims,
                  why="" if same else "visit counts differ")


def _gumbel(search: Search, root: Node, g: np.ndarray, pi: np.ndarray,
            played: Optional[int]) -> Replay:
    cfg = search.cfg
    sims = cfg["num_simulations"]
    m = max(1, min(cfg["max_considered"], cfg["max_children"], max(sims, 1)))
    logits = np.log(np.maximum(root.prior, 1e-30))
    base = g + logits
    cand = list(np.argsort(-base, kind="stable")[:m])

    def sigma() -> np.ndarray:
        return (cfg["c_visit"] + root.n.max()) * cfg["c_scale"] * completed_q(root)

    def ranked(width: int, keep: int) -> Tuple[np.ndarray, bool]:
        """The candidates' scores, -inf past ``width``, and whether two of
        the best ``keep`` + 1 lie within TOL (the next phase's order)."""
        sig = sigma()
        s = np.array([base[c] + sig[c] if r < width else -np.inf for r, c in enumerate(cand)])
        top = np.sort(s[np.isfinite(s)])[::-1][:keep + 1]
        return s, bool(len(top) > 1 and (np.diff(top) > -TOL).any())

    lo = 0
    segs = halving_schedule(sims, m)
    for si, (m_p, cnt) in enumerate(segs):
        eff = min(len(cand), m_p)
        for k in range(lo + 1, lo + cnt + 1):
            why = search.simulate(root, k, forced=cand[(k - 1 - lo) % eff])
            if why:
                return Replay(False, skipped=why.startswith("skip"), ties=search.ties, sims=k,
                              why=why)
        lo += cnt
        if si + 1 < len(segs):
            s, tied = ranked(m_p, segs[si + 1][0])
            if tied:
                return Replay(False, skipped=True, sims=lo, why="skip: a near-tie in the halving")
            cand = [cand[j] for j in np.argsort(-s, kind="stable")]
    s, _ = ranked(segs[-1][0], 0)
    best = [cand[j] for j in np.nonzero(s >= s.max() - TOL)[0]]
    target = _softmax(logits + sigma())
    gap = float(np.abs(pi.astype(np.float64) - target).max())
    acted = played is None or played in {int(root.actions[c]) for c in best}
    ok = acted and gap <= 1e-4
    why = "" if ok else ("the acted move is not the halving's winner" if not acted
                         else "the improved policy differs")
    return Replay(ok, ties=search.ties, pi_gap=gap, sims=sims, why=why)
