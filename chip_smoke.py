#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which asserts (any failure exits nonzero, nothing is caught
and carried on):

1. device: the card's name and count, and its power limit from nvidia-smi;
2. build: ``nvcc`` builds every ``csrc/*.cu`` for sm_90a, all at once;
3. kernel: the legal-mask kernel against its plain PyTorch version on the
   card, bit for bit (tolerance: exact equality), on boards of seeded random
   playouts plus the hand-made edge boards, at ragged batches; ~200 of them
   also against the pure-Python oracle;
4. search: ``run_mcts`` with a dyadic mock network gives exactly the CPU's
   visits on the card;
5. net: the card's forward of the 128-channel, 6-block net against the CPU
   forward of the same weights (float32 on both, TF32 off; atol 1e-3 on
   logits and values, for sums taken in other orders over 13 conv layers);
6. serve, the main path: a reference-layout ``.pt`` of seeded random weights
   at 128 channels x 6 blocks is served by the port's HTTP API on localhost,
   on the card, at 500 simulations: load_model, new_game, three human moves
   (each AI reply legal by the oracle), and four sessions moving at once
   (the searches must coalesce). The kernel's launch count is set to 0
   just before and read just after;
7. timings with CUDA events: the kernel, its plain version and its memory
   bound at B = 1, 8 and 2048, and the net forward at B = 1 and 8;
8. ``torch.profiler`` over one search of 100 simulations, for where an AI
   move's time goes (device busy share, launches, top kernels, host ops).

The line before the last lists each kernel as JSON; the last line is
``{"ok": true, "device": {...}}``. Without CUDA it exits nonzero before
printing any result.
"""

import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import torch

from xiangqi_alphazero_torch.engine import env as E
from xiangqi_alphazero_torch.engine.edge_boards import edge_boards
from xiangqi_alphazero_torch.engine.oracle import Position, decode_action
from xiangqi_alphazero_torch.models import XiangqiNet, load_reference_pt
from xiangqi_alphazero_torch.ops import _build
from xiangqi_alphazero_torch.ops import legal_mask as LM
from xiangqi_alphazero_torch.search import MCTSConfig, run_mcts
from xiangqi_alphazero_torch.serve.api import make_server
from xiangqi_alphazero_torch.serve.predictor import Predictor

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
INT32_OPS_PER_S = 33.5e12     # H100 SXM, 64 INT32 lanes per SM, half the fp32 rate
CHANNELS, BLOCKS = 128, 6     # the shipped model's width
SIMS = 500                    # the API's default search depth
PROFILE_SIMS = 100            # the profiler's cost grows with its events
BOARDS, PLIES, SEED = 2048, 60, 0   # random playouts for the kernel check
KERNELS = [
    {
        "name": "legal_mask",
        "route": "cuda",
        "source": "xiangqi_alphazero_torch/csrc/legal_mask.cu",
        "replaces": "xiangqi_alphazero_tpu/ops/legal_mask.py:393",
        "wrapper": LM.legal_mask_cuda,
        "library_ms": None,   # no single PyTorch call computes this function
    },
]


def log(*args) -> None:
    print(*args, flush=True)


# ------------------------------------------------------------------ phases


def phase_device() -> dict:
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"device: {name} (count {count}); torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return {"kind": name, "count": count, "smi": smi}


def phase_build() -> None:
    t0 = time.perf_counter()
    results = _build.build_all()
    log(f"build: {len(results)} source(s) in {time.perf_counter() - t0:.2f} s")
    for r in results.values():
        log(f"  {r.name}: nvcc {r.seconds:.2f} s -> {r.path.name}")
        for line in r.log.splitlines():
            if "Used" in line or "stack frame" in line:
                log("   ", line.strip())


def random_boards(dev, n: int, plies: int, seed: int):
    """Boards and sides of ``n`` seeded random playouts on ``dev``, kept
    every 10 plies, then the hand-made edge boards."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    st = E.reset_batch(n, device=dev)
    boards, sides = [st.board], [st.side]
    for ply in range(1, plies + 1):
        scores = torch.rand((n, E.ACTION_SPACE), generator=gen, device=dev)
        st = E.step_batch(st, torch.where(st.legal, scores, -1.0).argmax(dim=1))
        if ply % 10 == 0:
            boards.append(st.board)
            sides.append(st.side)
    edges = edge_boards().values()
    boards.append(torch.tensor(np.stack([b for b, _ in edges]), device=dev))
    sides.append(torch.tensor([s for _, s in edges], dtype=torch.int8, device=dev))
    return torch.cat(boards), torch.cat(sides)


def phase_kernel(dev, n: int, plies: int, seed: int):
    """Every kernel against its plain version; returns the boards and the
    largest difference seen (0 when bit-exact)."""
    boards, sides = random_boards(dev, n, plies, seed)
    n_edge = len(edge_boards())
    # ragged batches: the edge boards first, then the last plies' boards
    mix_b = torch.cat([boards[-n_edge:], boards[-n_edge - n:-n_edge]])
    mix_s = torch.cat([sides[-n_edge:], sides[-n_edge - n:-n_edge]])
    err = 0
    for b in (1, 7, 128, 129, 2048):
        b = min(b, len(mix_b))
        got = LM.legal_mask_cuda(mix_b[:b].contiguous(), mix_s[:b].contiguous())
        want = E.legal_mask(mix_b[:b], mix_s[:b])
        torch.cuda.synchronize()
        err = max(err, int((got.int() - want.int()).abs().max()))
        assert torch.equal(got, want), f"kernel != plain at B={b}"
        log(f"kernel vs plain, B={b}: equal ({int(got.sum())} legal moves)")
    for i in range(0, len(boards), 2048):
        b, s = boards[i:i + 2048], sides[i:i + 2048]
        got, want = LM.legal_mask_cuda(b, s), E.legal_mask(b, s)
        err = max(err, int((got.int() - want.int()).abs().max()))
        assert torch.equal(got, want), f"kernel != plain on boards {i}.."
    log(f"kernel vs plain: {len(boards)} boards equal")
    idx = np.unique(np.r_[np.linspace(0, len(boards) - 1, 190).astype(int),
                          np.arange(len(boards) - n_edge, len(boards))])
    got = LM.legal_mask_cuda(boards[idx].contiguous(), sides[idx].contiguous()).cpu()
    for row, i in enumerate(idx):
        pos = Position()
        pos.board = [int(x) for x in boards[i].tolist()]
        pos.side = int(sides[i])
        want = set(pos.legal_actions())
        assert set(torch.nonzero(got[row])[:, 0].tolist()) == want, f"oracle, board {i}"
    log(f"kernel vs oracle: {len(idx)} boards equal")
    return boards, sides, err


def advance_random(plies: int, seed: int) -> Position:
    """The oracle rolled forward by seeded random legal moves, history
    stripped (as the search parity of the JAX package's tests does)."""
    rng = np.random.default_rng(seed)
    pos = Position()
    for _ in range(plies):
        acts = pos.legal_actions()
        if pos.result()[0] or not acts:
            break
        pos.apply(int(rng.choice(acts)))
    fresh = Position()
    fresh.board, fresh.side = list(pos.board), pos.side
    return fresh


def dyadic_eval(feats):
    """Uniform 1/64 priors and value (own - opp) / 8: exact in float32 in
    any summation order, so the card and the CPU must choose alike."""
    own = feats[..., :7].sum(dim=(1, 2, 3))
    opp = feats[..., 7:14].sum(dim=(1, 2, 3))
    probs = torch.full((feats.shape[0], E.ACTION_SPACE), 1.0 / 64.0, device=feats.device)
    return probs, (own - opp) / 8.0


def phase_search(dev, sims: int = 64) -> None:
    cases = [advance_random(p, s) for p, s in
             [(0, 0), (3, 1), (8, 2), (15, 3), (26, 4), (37, 5)]]
    roots = E.cat_states([
        E.state_from_numpy(np.asarray(p.board, np.int8), p.side) for p in cases
    ])
    cfg = MCTSConfig(num_simulations=sims)
    with torch.inference_mode():
        cpu = run_mcts(dyadic_eval, roots, cfg, add_noise=False)
        card = run_mcts(dyadic_eval, roots.to(dev), cfg, add_noise=False)
    for f in ("visits", "actions", "order", "valid"):
        assert torch.equal(getattr(card, f).cpu(), getattr(cpu, f)), f
    log(f"search on the card == CPU: {len(cases)} positions x {sims} sims, "
        f"visits {card.visits.sum(dim=1).tolist()}")


def write_random_pt(path: str, seed: int) -> None:
    """A reference-layout .pt of seeded random weights at the shipped width,
    with non-trivial batch-norm statistics."""
    gen = torch.Generator().manual_seed(seed)
    torch.manual_seed(seed)
    net = XiangqiNet(CHANNELS, BLOCKS)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0.0, 0.1, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)
    torch.save(
        {"model_state_dict": net.state_dict(),
         "config": {"num_channels": CHANNELS, "num_res_blocks": BLOCKS}},
        path,
    )


def positions_features(dev, n: int, seed: int) -> torch.Tensor:
    boards, sides = [], []
    for i in range(n):
        p = advance_random(3 * i, seed + i)
        boards.append(p.board_array())
        sides.append(p.side)
    return E.features(torch.tensor(np.stack(boards), device=dev),
                      torch.tensor(sides, dtype=torch.int8, device=dev))


def phase_net(dev, pt: str) -> torch.nn.Module:
    cpu_net = load_reference_pt(pt)
    card_net = load_reference_pt(pt).to(dev)
    x = positions_features("cpu", 8, seed=11)
    with torch.inference_mode():
        want = cpu_net(x)
        got = card_net(x.to(dev))
    errs = [float((g.cpu() - w).abs().max()) for g, w in zip(got, want)]
    log(f"net {CHANNELS}ch/{BLOCKS}res, card vs CPU forward: max |d logits| "
        f"{errs[0]:.3g}, max |d value| {errs[1]:.3g} (atol 1e-3)")
    assert max(errs) <= 1e-3, errs
    return card_net


class Client:
    """JSON over HTTP to the local server (no proxy)."""

    def __init__(self, base: str):
        self.base = base
        self.opener = urllib.request.build_opener(urllib.request.ProxyHandler({}))

    def __call__(self, path: str, body=None):
        data = None if body is None else json.dumps(body).encode()
        req = urllib.request.Request(self.base + path, data=data)
        try:
            with self.opener.open(req, timeout=600) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())


def phase_serve(dev, model_dir: str, model_name: str, sims: int, seed: int) -> dict:
    """The main path: the HTTP API on the card. Returns latencies and the
    launch counts of this phase."""
    httpd, service = make_server("127.0.0.1", 0, [model_dir], device=dev)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    api = Client("http://127.0.0.1:%d" % httpd.server_address[1])
    kern = LM.legal_mask_cuda
    out = {"ai_move_s": [], "session_move_s": []}
    try:
        for k in KERNELS:
            k["wrapper"].launches = 0
        t0 = time.perf_counter()
        code, res = api("/api/load_model", {"model_name": model_name, "num_simulations": sims})
        assert code == 200 and res["success"], res
        out["load_model_s"] = time.perf_counter() - t0
        log(f"load_model ({sims} sims, warm-up search included): "
            f"{out['load_model_s']:.3f} s on {res['device']}")
        code, res = api("/api/models")
        assert code == 200 and res["device"] == torch.cuda.get_device_name(0), res
        assert all(p.device.type == dev.type for p in service.predictor.net.parameters())

        code, res = api("/api/new_game", {"human_side": "red", "num_simulations": sims})
        assert code == 200 and res["current_player"] == 1, res
        pos = Position()
        rng = np.random.default_rng(seed)
        for move in range(3):
            a = int(rng.choice(pos.legal_actions()))
            fr, fc, tr, tc = decode_action(a)
            before = kern.launches
            t0 = time.perf_counter()
            code, res = api("/api/human_move", {"from_row": fr, "from_col": fc,
                                                 "to_row": tr, "to_col": tc})
            dt = time.perf_counter() - t0
            assert code == 200, res
            pos.apply(a)
            ai = res["ai_move"]["action"]
            assert ai in pos.legal_actions(), f"illegal AI move {ai}"
            pos.apply(ai)
            assert res["board"] == pos.board_array().reshape(10, 9).tolist()
            launched = kern.launches - before
            assert launched >= 1 + sims, launched
            out["ai_move_s"].append(dt)
            log(f"human_move {move + 1}: AI reply {res['ai_move']['label']} in "
                f"{dt:.3f} s ({sims} sims, {launched} kernel launches)")
        code, res = api("/api/human_move", {"from_row": 0, "from_col": 0,
                                             "to_row": 5, "to_col": 5})
        assert code == 400, res
        code, res = api("/api/load_model", {"model_name": "missing.pt"})
        assert code == 404, res

        sids = []
        for _ in range(4):
            code, res = api("/api/session/new", {"human_side": "red"})
            assert code == 200, res
            sids.append(res["session_id"])
        replies = [None] * len(sids)

        def play(i):
            t0 = time.perf_counter()
            replies[i] = api("/api/session/move", {
                "session_id": sids[i], "from_row": 3, "from_col": 0,
                "to_row": 4, "to_col": 0,
            }) + (time.perf_counter() - t0,)

        threads = [threading.Thread(target=play, args=(i,)) for i in range(len(sids))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        start = Position()
        start.apply(27 * 90 + 36)   # the pawn (3,0) -> (4,0)
        for code, res, dt in replies:
            assert code == 200, res
            assert res["ai_move"]["action"] in start.legal_actions(), res["ai_move"]
            out["session_move_s"].append(dt)
        code, stats = api("/api/session/stats")
        assert code == 200 and stats["search"]["mean_batch"] > 1, stats
        log(f"4 concurrent session moves: {[round(x, 3) for x in out['session_move_s']]} s, "
            f"search stats {stats['search']}")
    finally:
        httpd.shutdown()
        httpd.server_close()
        if service.searcher is not None:
            service.searcher.stop()
        thread.join()
    out["launches"] = {k["name"]: k["wrapper"].launches for k in KERNELS}
    for name, n in out["launches"].items():
        assert n > 0, f"kernel {name} was not launched on the main path"
    log(f"main path kernel launches: {out['launches']}")
    return out


def cuda_ms(fn, iters: int) -> float:
    """Mean ms per call over ``iters`` calls, timed with CUDA events after
    a warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def mask_bound_ms(batch: int) -> tuple:
    """The least time for the mask of ``batch`` boards: its bytes (90 board
    bytes and 1 side byte read, 8100 mask bytes written, per board) over the
    memory rate, against its operations (at least one test per action) over
    the int32 rate."""
    t_bytes = batch * (E.NSQ + 1 + E.ACTION_SPACE) / HBM_BYTES_PER_S * 1e3
    t_ops = batch * E.ACTION_SPACE / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_timings(dev, boards, sides, net) -> dict:
    kern = LM.legal_mask_cuda
    saved = kern.launches
    rows = {}
    for b in (1, 8, 2048):
        bb, ss = boards[-b:].contiguous(), sides[-b:].contiguous()
        iters = 200 if b < 2048 else 50
        ms = cuda_ms(lambda: kern(bb, ss), iters)
        plain = cuda_ms(lambda: E.legal_mask(bb, ss), max(iters // 10, 5))
        bound, by = mask_bound_ms(b)
        rows[b] = {"ms": ms, "plain_ms": plain, "bound_ms": bound, "bound_by": by,
                   "share_of_bound": bound / ms}
        log(f"legal_mask B={b}: kernel {ms:.5f} ms, bound {bound:.6f} ms ({by}), "
            f"share of bound {bound / ms:.4f}; plain version {plain:.5f} ms "
            f"(not a yardstick)")
    kern.launches = saved   # timing launches are not main-path launches
    with torch.inference_mode():
        for b in (1, 8):
            x = positions_features(dev, b, seed=21)
            log(f"net forward {CHANNELS}ch/{BLOCKS}res B={b}: "
                f"{cuda_ms(lambda: net(x), 50):.4f} ms")
    return rows


_NET_KERNEL_WORDS = ("conv", "gemm", "cudnn", "xmma", "cutlass", "implicit", "winograd")


def phase_profile(dev, net, sims: int) -> None:
    """Where one AI move's time goes: ``torch.profiler`` over one search of
    the opening at ``sims`` simulations, on a warmed predictor."""
    from torch.profiler import ProfilerActivity, profile

    pred = Predictor(net, num_simulations=sims, device=dev)
    pos = Position()
    pred.search_position(pos)
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        pred.search_position(pos)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    launches = sum(e.count for e in kernels)
    log(f"profile, one search of {sims} sims (profiler on): wall {wall:.4f} s, "
        f"device busy {busy:.4f} s, idle share {1 - busy / wall:.4f}, "
        f"{launches} device kernels ({launches / sims:.1f} per simulation)")
    groups = {"net (conv/gemm)": 0.0, "legal_mask_kernel": 0.0, "other": 0.0}
    for e in kernels:
        name = e.key.lower()
        key = ("legal_mask_kernel" if "legal_mask_kernel" in name else
               "net (conv/gemm)" if any(w in name for w in _NET_KERNEL_WORDS) else "other")
        groups[key] += e.self_device_time_total / 1e6
    log("  device time by group: " + ", ".join(
        f"{k} {v:.4f} s" for k, v in groups.items()))
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<6d} {e.key[:90]}")
    host = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CPU]
    log(f"  host: {sum(e.count for e in host)} profiled ops; top by self CPU time:")
    for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:12]:
        log(f"  {e.self_cpu_time_total / 1e3:9.3f} ms  x{e.count:<6d} {e.key[:90]}")


# -------------------------------------------------------------------- main


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA card",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t_start = time.perf_counter()

    device = phase_device()
    phase_build()
    boards, sides, err = phase_kernel(dev, BOARDS, PLIES, SEED)
    phase_search(dev)
    with tempfile.TemporaryDirectory() as tmp:
        name = f"random_{CHANNELS}x{BLOCKS}.pt"
        write_random_pt(os.path.join(tmp, name), SEED)
        net = phase_net(dev, os.path.join(tmp, name))
        serve = phase_serve(dev, tmp, name, SIMS, SEED)
    rows = phase_timings(dev, boards, sides, net)
    phase_profile(dev, net, PROFILE_SIMS)
    log(f"AI move latency at {SIMS} sims: "
        f"{[round(x, 4) for x in serve['ai_move_s']]} s; "
        f"total {time.perf_counter() - t_start:.1f} s")

    kernels = []
    for k in KERNELS:
        main_row = rows[1]   # serving's AI move runs the kernel at B = 1
        kernels.append({
            "name": k["name"], "route": k["route"], "source": k["source"],
            "replaces": k["replaces"], "launches": serve["launches"][k["name"]],
            "max_abs_err": err, "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
            "library_ms": k["library_ms"],
            "by_batch": {str(b): r for b, r in rows.items()},
        })
    log(device["smi"])
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device["kind"], "count": device["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
