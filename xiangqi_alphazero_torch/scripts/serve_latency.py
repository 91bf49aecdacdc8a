"""Serving latency: p50/p95 AI-move latency over the simulation budget and
the number of concurrent sessions.

Port of the repo's ``scripts/serve_latency.py``. Concurrent sessions are
coalesced by ``serve.sessions.BatchedSearcher`` into batched searches (the
code path ``serve.api`` drives), and each request's wall clock is taken at
the searcher's boundary. Every cell issues a fixed number of requests, and
``BatchedSearcher.warmup`` runs every batch width first, so no cell times a
cold path. The JAX script warms each concurrency value at each depth,
because XLA compiles a program per shape and depth. The port compiles
nothing per depth: a shallow search at each width loads every kernel and
sets cuDNN's algorithms for each batch shape, so each width is warmed once.

Every request is the opening position, as in the JAX script (see
``_midgame_positions``). p95 is numpy's interpolated percentile of the
cell's requests: with fewer than ~20 requests it lies between the two
slowest, so each cell also reports its slowest request and its count.

    python -m xiangqi_alphazero_torch.scripts.serve_latency --model best.pt \\
        [--sims 100,500,2000] [--conc 1,4,8] [--requests 24] [--algo puct|gumbel] \\
        [--device cpu]

``--model`` is a ``.pt`` or a trainer's ``checkpoint_iter{N}``. Prints a
markdown table and, last, one JSON line ``{"ok", "algo", "cells"}``; each
cell carries p50, p95, max, the request count, moves/s and the mean
coalesced batch.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time

import numpy as np

from ..engine.oracle import Position

WARM_SIMS = 4   # the warm-up search's depth: deep enough to descend past the root


def _midgame_positions(n: int, seed: int = 3):
    """The JAX script's request positions (same signature). Its random walk
    stops before the first move at ``pos.result() is not None``, which
    holds for every position (``result()`` returns a ``(done, winner)``
    pair), so every request there is the opening. The port keeps that, so
    that the two grids time the same searches; ``seed`` seeded the walk."""
    return [Position() for _ in range(n)]


def run_grid(predictor, sims_list, conc_list, requests: int):
    """Time every (sims, concurrency) cell on ``predictor``'s net and
    search. Returns the rows ``(sims, conc, p50_ms, p95_ms, max_ms, n,
    moves_per_s, mean_batch)``, unrounded, in grid order; ``n`` is the
    cell's request count."""
    from ..serve.sessions import BatchedSearcher

    positions = _midgame_positions(max(requests, 32))
    cap = max(conc_list)
    print(f"[warmup] every batch width up to {cap}...", file=sys.stderr, flush=True)
    warm = BatchedSearcher(predictor.with_simulations(WARM_SIMS), max_batch=cap)
    try:
        warm.warmup()
    finally:
        warm.stop()
    rows = []
    for sims in sims_list:
        searcher = BatchedSearcher(predictor.with_simulations(sims), max_batch=cap)
        try:
            for conc in conc_list:
                lat, lock = [], threading.Lock()
                per_thread = max(1, requests // conc)
                before = (searcher.num_batches, searcher.num_requests)

                def client(tid: int):
                    for j in range(per_thread):
                        pos = positions[(tid * per_thread + j) % len(positions)]
                        t0 = time.perf_counter()
                        searcher.search(pos)
                        dt = time.perf_counter() - t0
                        with lock:
                            lat.append(dt)

                threads = [threading.Thread(target=client, args=(t,)) for t in range(conc)]
                t_all = time.perf_counter()
                for t in threads:
                    t.start()
                for t in threads:
                    t.join()
                wall = time.perf_counter() - t_all
                ms = np.asarray(sorted(lat)) * 1e3
                batches = searcher.num_batches - before[0]
                mean_batch = (searcher.num_requests - before[1]) / max(batches, 1)
                row = (sims, conc, float(np.percentile(ms, 50)), float(np.percentile(ms, 95)),
                       float(ms[-1]), len(lat), len(lat) / wall, mean_batch)
                rows.append(row)
                print(f"sims={sims} conc={conc}: p50={row[2]:.0f} ms p95={row[3]:.0f} ms "
                      f"max={row[4]:.0f} ms over {len(lat)} requests, {row[6]:.2f} moves/s, "
                      f"mean batch {mean_batch:.2f}", file=sys.stderr, flush=True)
        finally:
            searcher.stop()
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="AI-move latency over sims and sessions. Every request searches the "
                    "opening position, as the JAX script's do; p95 needs ~20 or more "
                    "requests a cell to be a tail, so each cell also reports its max.")
    p.add_argument("--model", required=True,
                   help="a .pt or a trainer's checkpoint_iter{N}")
    p.add_argument("--sims", default="100,500,2000")
    p.add_argument("--conc", default="1,4,8")
    p.add_argument("--requests", type=int, default=24)
    p.add_argument("--algo", default="puct", choices=["puct", "gumbel"])
    p.add_argument("--device", default="cuda",
                   help="torch device to serve on (default cuda; 'cpu' for the CPU)")
    args = p.parse_args(argv)

    from ..serve.predictor import Predictor

    sims_list = [int(s) for s in args.sims.split(",")]
    conc_list = [int(c) for c in args.conc.split(",")]
    pred = Predictor.load(args.model, num_simulations=sims_list[0], algo=args.algo,
                          device=args.device)
    rows = run_grid(pred, sims_list, conc_list, args.requests)

    print("\n| sims | concurrent sessions | p50 | p95 | max | requests | moves/s | mean batch |")
    print("|---|---|---|---|---|---|---|---|")
    for sims, conc, p50, p95, top, n, thr, mb in rows:
        print(f"| {sims} | {conc} | {p50:,.0f} ms | {p95:,.0f} ms | {top:,.0f} ms | {n} "
              f"| {thr:.2f} | {mb:.2f} |")
    cells = {f"s{sims}_c{conc}": {"p50_ms": round(p50, 1), "p95_ms": round(p95, 1),
                                  "max_ms": round(top, 1), "requests": n,
                                  "moves_per_s": round(thr, 2), "mean_batch": round(mb, 3)}
             for sims, conc, p50, p95, top, n, thr, mb in rows}   # rounded as the JAX script
    print(json.dumps({"ok": True, "algo": args.algo, "cells": cells}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
