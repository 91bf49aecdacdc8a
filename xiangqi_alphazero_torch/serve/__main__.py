"""Serving CLI.

  python -m xiangqi_alphazero_torch.serve api --port 5000 --model-dirs models

Serves reference-layout ``.pt`` models found in ``--model-dirs`` on the card
(``--device cpu`` runs on the CPU; ``--search gumbel`` serves with the
Gumbel root search). An orbax bundle of the JAX package is
turned into one with its own CLI:
``python -m xiangqi_alphazero_tpu.serve export --checkpoint <dir> --format
torch --output model.pt``.
"""

import argparse
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="xiangqi_alphazero_torch.serve")
    sub = p.add_subparsers(dest="cmd", required=True)

    ap = sub.add_parser("api", help="run the human-vs-AI REST API")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=5000)
    ap.add_argument("--model-dirs", nargs="*", default=None)
    ap.add_argument(
        "--warm-session-buckets", action="store_true",
        help="run every session-coalescing batch shape once at model load",
    )
    ap.add_argument(
        "--search", choices=["puct", "gumbel"], default="puct",
        help="puct = the reference's search semantics; gumbel = the "
             "sequential-halving root (stronger per simulation: pair "
             "with a low num_simulations for low-latency serving)",
    )
    ap.add_argument(
        "--device", default="cuda",
        help="torch device to serve on (default cuda; 'cpu' for the CPU)",
    )
    args = p.parse_args(argv)

    from .api import serve

    serve(args.host, args.port, args.model_dirs,
          warm_sessions=args.warm_session_buckets, device=args.device,
          search_algo=args.search)
    return 0


if __name__ == "__main__":
    sys.exit(main())
