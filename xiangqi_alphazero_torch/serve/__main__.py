"""Serving CLI.

  python -m xiangqi_alphazero_torch.serve api --port 5000 --model-dirs models
  python -m xiangqi_alphazero_torch.serve export --checkpoint ckpt/best_model.pt \
      --format torch|npz|onnx|torchscript --output model.pt

``api`` serves reference-layout ``.pt`` models found in ``--model-dirs`` on
the card (``--device cpu`` runs on the CPU; ``--search gumbel`` serves with
the Gumbel root search). ``export`` writes a ``.pt`` or a training
checkpoint (``checkpoint_iter{N}``, its best net) in one of four formats and
verifies the file against the net's float32 forward on ``--device``
(reference CLI: training/export_model.py:90-101). An orbax bundle of the JAX
package is turned into a ``.pt`` with its own CLI:
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
    ep = sub.add_parser("export", help="export a trained model")
    ep.add_argument("--checkpoint", required=True)
    ep.add_argument(
        "--format",
        choices=["torch", "npz", "onnx", "torchscript"],
        default="torch",
    )
    ep.add_argument("--output", required=True)
    ep.add_argument(
        "--no-verify", action="store_true",
        help="skip the numeric round-trip check of the exported artifact",
    )
    ep.add_argument(
        "--device", default="cuda",
        help="torch device of the verifying forward (default cuda; 'cpu' "
             "for the CPU)",
    )
    args = p.parse_args(argv)

    if args.cmd == "api":
        from .api import serve

        serve(args.host, args.port, args.model_dirs,
              warm_sessions=args.warm_session_buckets, device=args.device,
              search_algo=args.search)
        return 0

    from .export import EXPORTERS, verify_export
    from .predictor import Predictor

    net = Predictor.load(args.checkpoint, num_simulations=1, device=args.device).net
    EXPORTERS[args.format](args.output, net)
    print(f"exported {args.format} -> {args.output}")
    if not args.no_verify:
        diffs = verify_export(args.format, args.output, net)
        print(
            "verified against the net's float32 forward: "
            f"max|dlogits|={diffs['max_abs_dlogits']:.4e} "
            f"max|dvalue|={diffs['max_abs_dvalue']:.4e}"
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
