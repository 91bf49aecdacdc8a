#!/usr/bin/env bash
# Host readiness for the PyTorch port (xiangqi_alphazero_torch) on an H100.
# Reports each item as ok or missing and exits 1 if any is missing:
#   - Python 3.12;
#   - torch built with CUDA, and an sm_90 card (its name and power limit
#     from nvidia-smi);
#   - nvcc that targets sm_90a;
#   - the port's two native builds: the legal-mask kernel (ops/_build.py,
#     nvcc) and the rules core (engine/native, the host's C++ compiler),
#     built into xiangqi_alphazero_torch/_build/ if absent.
# The JAX package's runtime (jax[tpu], flax, optax, orbax) is not needed.
#
# Usage: bash xiangqi_alphazero_torch/scripts/setup_env.sh
set -u
cd "$(dirname "$0")/../.."
ok=1
say() { printf '%-40s %s\n' "$1" "$2"; }
PY="${PYTHON:-python}"

if "$PY" -c 'import sys; sys.exit(sys.version_info[:2] != (3, 12))' 2>/dev/null; then
  say "python 3.12" "ok ($("$PY" -c 'import sys; print(sys.version.split()[0])'))"
else
  say "python 3.12" "missing ($("$PY" -c 'import sys; print(sys.version.split()[0])' 2>&1))"; ok=0
fi

if command -v nvidia-smi >/dev/null && smi=$(nvidia-smi --query-gpu=name,power.limit --format=csv,noheader 2>/dev/null); then
  say "nvidia-smi (name, power limit)" "ok ($(echo "$smi" | head -n 1))"
else
  say "nvidia-smi (name, power limit)" "missing"; ok=0
fi

# torch, the card, nvcc and both native builds, in one interpreter
"$PY" - <<'PY' || ok=0
import sys

failed = False


def say(item, state):
    global failed
    failed |= not state.startswith("ok")
    print(f"{item:<40} {state}", flush=True)


try:
    import torch
except ImportError:
    say("torch", "missing")
    sys.exit(1)
if torch.version.cuda and torch.cuda.is_available():
    cap = torch.cuda.get_device_capability(0)
    name = torch.cuda.get_device_name(0)
    say(f"torch {torch.__version__} with CUDA {torch.version.cuda}", "ok")
    say("sm_90 card", f"ok ({name})" if cap == (9, 0) else f"missing ({name}, sm_{cap[0]}{cap[1]})")
else:
    say(f"torch {torch.__version__} with CUDA", "missing (no CUDA build or no card)")

import subprocess

from xiangqi_alphazero_torch.engine import native
from xiangqi_alphazero_torch.ops import _build

try:
    nvcc = _build.nvcc()
    codes = subprocess.run([nvcc, "--list-gpu-code"], capture_output=True, text=True).stdout
    say("nvcc with sm_90a", f"ok ({nvcc})" if "sm_90a" in codes.split() else f"missing ({nvcc})")
except RuntimeError as e:
    say("nvcc with sm_90a", f"missing ({e})")
try:
    built = _build.build_all()
    say("legal-mask kernel build (nvcc)", "ok (" + ", ".join(r.path.name for r in built.values()) + ")")
except Exception as e:  # noqa: BLE001 — reported, not raised
    say("legal-mask kernel build (nvcc)", f"missing ({type(e).__name__}: {str(e).splitlines()[0][:80]})")
say("native rules core (C++)",
    f"ok ({native.library_path().name})" if native.available()
    else f"missing (compiler {native.compiler()})")
sys.exit(1 if failed else 0)
PY

if [ "$ok" = 1 ]; then
  echo "environment ready. smoke run on the card: python3 chip_smoke.py"
else
  echo "not ready: see the missing items above"
  exit 1
fi
