#!/usr/bin/env bash
# The flagship run on the port: the reference's full-preset width (256
# channels, 10 residual blocks; reference: training/train.py:692-704),
# trained with the repo's production recipe (Gumbel-32 self-play, 256 games
# an iteration) under the --auto-restart supervisor. It is the recipe of the
# repo's scripts/flagship_run.sh, run through the port's CLI:
#   - Gumbel-32 self-play (m = 16) instead of PUCT-400;
#   - 256 games an iteration instead of 50;
#   - a replay ring of 150k samples, batch 1024.
# Left out: --train-segment 384. It bounded the length of one TPU program
# for the TPU's watchdog; the port's learner steps from the host and its
# config refuses the option.
#
# Usage: bash xiangqi_alphazero_torch/scripts/flagship_run.sh [iterations] [flags...]
# Further flags go to the CLI and override the recipe's (argparse keeps the
# last), e.g. --device cpu, or --checkpoint-dir DIR. Checkpoints go to
# runs/torch/flagship by default.
set -e
cd "$(dirname "$0")/../.."
ITERS="${1:-200}"
[ "$#" -gt 0 ] && shift
export XQAZ_STALL_TIMEOUT_S=2700
exec "${PYTHON:-python}" -m xiangqi_alphazero_torch.train \
  --mode tpu \
  --channels 256 --res-blocks 10 \
  --search-algo gumbel --simulations 32 --max-considered 16 \
  --games-per-iter 256 --iterations "$ITERS" \
  --max-buffer 150000 --batch-size 1024 \
  --eval-interval 5 --save-interval 5 \
  --seed 7 --auto-restart 60 \
  --checkpoint-dir runs/torch/flagship \
  "$@"
