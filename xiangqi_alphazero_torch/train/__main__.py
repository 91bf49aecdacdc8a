"""CLI entry: python -m xiangqi_alphazero_torch.train --mode quick|standard|full|tpu

Mirrors the JAX package's CLI (reference: training/train.py:707-764): the
presets, their overrides, ``--resume PATH`` (a ``checkpoint_iter{N}``) and
``--init-from PATH`` (a ``best_model.pt``). Trains on the card unless given
``--device cpu``. The JAX CLI's ``--auto-restart`` supervisor and its
multi-host flags are not ported and raise (see ``config.check_supported``).
"""

import logging
import os
import sys

from .config import build_argparser, config_from_args


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    cfg, resume = config_from_args(args)

    from .trainer import AlphaZeroTrainer

    os.makedirs(cfg.checkpoint_dir, exist_ok=True)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s [%(levelname)s] %(message)s",
        handlers=[
            logging.StreamHandler(),
            logging.FileHandler(os.path.join(cfg.checkpoint_dir, "training.log")),
        ],
        force=True,
    )
    trainer = AlphaZeroTrainer(cfg, device=args.device)
    trainer.train(resume=resume, init_from=args.init_from)
    return 0


if __name__ == "__main__":
    sys.exit(main())
