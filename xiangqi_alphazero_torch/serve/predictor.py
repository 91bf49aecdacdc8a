"""Serving predictor: checkpoint loading, search, analysis payload.

Port of ``xiangqi_alphazero_tpu.serve.predictor``. Loads reference-layout
``.pt`` checkpoints and the port's own training checkpoints (the JAX
package's orbax bundles are exported to a ``.pt`` with ``python -m
xiangqi_alphazero_tpu.serve export --format torch``). The
search is the batched PUCT search (``algo="puct"``, the reference's
semantics) or the Gumbel root search (``algo="gumbel"``, stronger per
simulation, so it can serve at a fraction of the simulations); the
human-facing game state is the host oracle ``Position``. Every Gumbel
search draws its root noise from a fresh CPU generator seeded 0, as the JAX
Predictor draws from ``jax.random.key(0)``: a position gets the same reply
every time, and a lane of a coalesced batch the same as a search alone.

Runs on the card unless the caller passes ``device="cpu"``; without CUDA a
default-device Predictor raises instead of falling back. The net serves in
full float32, as the JAX Predictor does: TF32 is turned off for cuDNN
convolutions and for matmuls, because at serving's batch of 1..8 the net is
launch-bound (TF32 would save nothing) and TF32's ~1e-3 relative error
would let the card's search break near-ties differently from the CPU's.
"""

from __future__ import annotations

import os
import pickle
import re
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..engine import env as E
from ..engine.oracle import PIECE_NAMES, Position, decode_action
from ..models import XiangqiNet, load_reference_pt, policy_value_fn
from ..search import GumbelConfig, MCTSConfig, run_gumbel_mcts, run_mcts

_EXPORT_HINT = (
    "python -m xiangqi_alphazero_tpu.serve export --checkpoint {path} "
    "--format torch --output model.pt"
)


def resolve_device(device=None) -> torch.device:
    """The device to run on: CUDA unless the caller names another. Raises
    when CUDA is wanted and missing, rather than falling back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev


def device_name(device: torch.device) -> str:
    """The card's name (torch.cuda.get_device_name), or 'cpu'."""
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def state_from_position(pos: Position, device="cpu") -> E.EnvState:
    """A batch-1 EnvState mirroring an oracle Position, including the
    repetition ring."""
    hist = np.zeros((E.HIST_LEN, 90), np.int8)
    recent = pos.history[-E.HIST_LEN:]
    for i, h in enumerate(recent):
        idx = (pos.ply - len(recent) + i) % E.HIST_LEN
        hist[idx] = np.frombuffer(h, np.uint8).astype(np.int8)
    return E.state_from_numpy(
        pos.board_array(), pos.side, pos.ply, pos.quiet, hist, device=device
    )


def format_move(action: int, pos: Position) -> str:
    """Human-readable move label (reference: demo/app.py:118-128)."""
    fr, fc, tr, tc = decode_action(action)
    piece = pos.at(fr, fc)
    captured = pos.at(tr, tc)
    s = f"{PIECE_NAMES.get(piece, '?')}({fr},{fc})→({tr},{tc})"
    if captured != 0:
        s += f" 吃{PIECE_NAMES.get(captured, '')}"
    return s


def find_models(search_dirs: List[str]) -> List[Dict]:
    """Discover loadable models (reference: demo/app.py:50-74): ``.pt``
    files and the trainer's ``checkpoint_iter{N}`` files (which
    ``load_serving_net`` serves; their ``.replay.npz`` rings are not
    models). Directories, the JAX package's orbax bundles among them, are
    not listed: the port cannot load them."""
    out = []
    for d in search_dirs:
        if not os.path.isdir(d):
            continue
        for name in sorted(os.listdir(d)):
            path = os.path.join(d, name)
            if not os.path.isfile(path):
                continue
            if name.endswith(".pt"):
                out.append({"name": name, "path": path, "format": "torch"})
            elif re.fullmatch(r"checkpoint_iter\d+", name):
                out.append({"name": name, "path": path, "format": "checkpoint"})
    return out


def load_serving_net(path: str) -> XiangqiNet:
    """The net that the file at ``path`` serves, on the CPU in eval mode: a
    reference-layout ``.pt`` (``{"model_state_dict", "config"}``), or a
    training checkpoint of ``train/checkpoint.py`` (its ``best_params``,
    with its ``config``'s topology, as the JAX Predictor takes
    ``best_params`` from a full checkpoint). An orbax directory of the JAX
    package is refused with the command that exports it."""
    refused = (f"{path} is not a .pt model or a training checkpoint; export an "
               "orbax model with " + _EXPORT_HINT.format(path=path))
    if os.path.isdir(path):
        raise ValueError(refused)
    if path.endswith(".pt"):
        return load_reference_pt(path)
    try:
        payload = torch.load(path, map_location="cpu", weights_only=True)
    except (pickle.UnpicklingError, RuntimeError, EOFError) as e:
        raise ValueError(refused) from e
    if not isinstance(payload, dict) or "best_params" not in payload:
        raise ValueError(refused)
    mc = payload["config"]
    net = XiangqiNet(channels=int(mc["num_channels"]), blocks=int(mc["num_res_blocks"]))
    net.load_state_dict(payload["best_params"])
    return net.eval()


class Predictor:
    def __init__(
        self,
        net: XiangqiNet,
        num_simulations: int = 500,
        c_puct: float = 1.5,
        algo: str = "puct",
        device=None,
    ):
        if algo not in ("puct", "gumbel"):
            raise ValueError(f"unknown search algo {algo!r}")
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        self.net = net.to(self.device).eval()
        self.num_simulations = int(num_simulations)
        self.c_puct = float(c_puct)
        # "puct" = the reference's search semantics (mcts.py:94-155);
        # "gumbel" = the sequential-halving root (search/gumbel.py)
        self.algo = algo

    # ------------------------------------------------------------- loading
    @classmethod
    def load(cls, path: str, num_simulations: int = 500, algo: str = "puct",
             device=None) -> "Predictor":
        """A Predictor serving the model at ``path``: a reference-layout
        ``.pt``, or the best net of a full training checkpoint
        (``checkpoint_iter{N}``), as the JAX Predictor serves both."""
        return cls(load_serving_net(path), num_simulations, algo=algo,
                   device=device)

    def with_simulations(self, num_simulations: int) -> "Predictor":
        """Shallow clone sharing the network and the search algorithm, with
        its own search depth."""
        return Predictor(self.net, num_simulations, self.c_puct,
                         algo=self.algo, device=self.device)

    # ----------------------------------------------------------- inference
    def warmup(self) -> None:
        """Run the forward and the search once now (building the CUDA kernel
        and warming cuDNN), so the first human_move doesn't pay for it."""
        pos = Position()
        self.raw_predict(pos)
        self.search_position(pos)

    def _features(self, positions: List[Position]) -> torch.Tensor:
        board = torch.as_tensor(
            np.stack([p.board_array() for p in positions]), device=self.device
        )
        side = torch.tensor([p.side for p in positions], dtype=torch.int8,
                            device=self.device)
        return E.features(board, side)

    @torch.inference_mode()
    def raw_predict(self, pos: Position) -> Tuple[np.ndarray, float]:
        """(softmax policy[8100], value) for a single position — the
        reference's model.predict (model.py:109-124)."""
        probs, value = policy_value_fn(self.net)(self._features([pos]))
        return probs[0].cpu().numpy(), float(value[0])

    @torch.inference_mode()
    def raw_predict_batch(
        self, positions: List[Position], pad_to: Optional[int] = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(policy[n, 8100], value[n]) for several positions in one forward;
        ``pad_to`` pads the batch by repeating positions[0]."""
        n = len(positions)
        padded = positions + [positions[0]] * (max(pad_to or n, n) - n)
        probs, value = policy_value_fn(self.net)(self._features(padded))
        return probs[:n].cpu().numpy(), value[:n].cpu().numpy()

    @torch.inference_mode()
    def _search(self, state: E.EnvState) -> List[Tuple]:
        """One search over the batch; per lane (actions, visits, order),
        and with Gumbel the chosen action as a fourth entry."""
        fn = policy_value_fn(self.net)
        if self.algo == "gumbel":
            gcfg = GumbelConfig(num_simulations=self.num_simulations,
                                max_considered=min(16, max(1, self.num_simulations)))
            res = run_gumbel_mcts(fn, state, gcfg, generator=torch.Generator().manual_seed(0))
            extra = (res.chosen.cpu().numpy(),)
        else:
            cfg = MCTSConfig(num_simulations=self.num_simulations, c_puct=self.c_puct)
            res = run_mcts(fn, state, cfg, add_noise=False)
            extra = ()
        cols = (res.actions.cpu().numpy(), res.visits.cpu().numpy(),
                res.order.cpu().numpy()) + extra
        return [tuple(c[i] if c.ndim > 1 else int(c[i]) for c in cols)
                for i in range(state.board.shape[0])]

    def search_position(self, pos: Position) -> Tuple:
        """Run the search (no noise, greedy analysis). Returns (actions,
        visits, order), and with Gumbel (actions, visits, order, chosen):
        ``order`` is the movegen-precedence key per slot (ascending == the
        reference engine's enumeration order; -1 pads), ``chosen`` the
        halving's winner."""
        return self._search(state_from_position(pos, self.device))[0]

    def search_batch(self, positions: List[Position], pad_to: Optional[int] = None) -> List[Tuple]:
        """One batched search over several independent positions. Lanes are
        independent (no cross-lane reductions, inference-mode batch norm,
        and a lane's Gumbel draws do not depend on the batch width), so each
        lane equals a batch-1 ``search_position`` of its position.
        ``pad_to`` pads the batch by repeating positions[0]."""
        n = len(positions)
        padded = positions + [positions[0]] * (max(pad_to or n, n) - n)
        state = E.cat_states([state_from_position(p, self.device) for p in padded])
        return self._search(state)[:n]

    # ------------------------------------------------------------ analysis
    def ai_move(self, pos: Position) -> Dict:
        """Pick the greedy move and produce the analysis payload
        (reference: demo/app.py:322-387)."""
        return self.ai_move_from_search(pos, self.search_position(pos))

    def ai_move_from_search(
        self,
        pos: Position,
        search: Tuple,
        raw: Optional[Tuple[np.ndarray, float]] = None,
    ) -> Dict:
        """Analysis payload from an already-run search; ``raw`` optionally
        supplies the (policy, value) forward for the position. 'prob' is the
        visit-proportional search distribution, as in the JAX package."""
        actions, visits, mg_order = search[:3]
        raw_policy, value_score = raw if raw is not None else self.raw_predict(pos)
        value_score = float(value_score)
        legal = set(pos.legal_actions())

        total = max(visits.sum(), 1)
        order = np.argsort(visits)[::-1][:15]
        if len(search) > 3 and search[3] >= 0:
            # gumbel: the acted move is the halving winner by
            # g + logits + sigma(q), not the max-visit child
            selected = int(search[3])
        else:
            # temp-0 pick: first max-visit child in the reference's movegen
            # order (its max() over the insertion-ordered dict, mcts.py:198)
            tied = np.flatnonzero((actions >= 0) & (visits == visits.max()))
            selected = int(actions[tied[np.argmin(mg_order[tied])]])

        top_moves = []
        for j in order:
            if visits[j] <= 0 or actions[j] < 0:
                continue
            a = int(actions[j])
            fr, fc, tr, tc = decode_action(a)
            top_moves.append(
                {
                    "action": a,
                    "from": [fr, fc],
                    "to": [tr, tc],
                    "prob": round(float(visits[j] / total), 4),
                    "raw_prob": round(float(raw_policy[a]), 6),
                    "legal": a in legal,
                    "selected": a == selected,
                    "label": format_move(a, pos),
                }
            )

        label = format_move(selected, pos)
        fr, fc, tr, tc = decode_action(selected)
        pos.apply(selected)
        done, winner = pos.result()
        return {
            "board": pos.board_array().reshape(10, 9).tolist(),
            "current_player": pos.side,
            "game_over": done,
            "winner": int(winner) if winner else None,
            "ai_move": {
                "from": [fr, fc],
                "to": [tr, tc],
                "action": selected,
                "label": label,
            },
            "ai_analysis": {
                "value_score": round(value_score, 4),
                "top_moves": top_moves,
                "num_simulations": self.num_simulations,
            },
        }
