"""Run one cell of the port's benchmark once and print its result line.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell is found by name in
``BENCHMARK.json``; its configuration (``configs/<config>.json``), its
traffic (``traffic/<traffic>.json``, whose ``driver`` names the module of
``drivers/`` that drives it) and the limits of its check
(``limits/<workload>.json``) by the names there; each per-layer metric by
its own reader, ``metrics/<name>.py``. Nothing here names a cell.

``--trace 0`` makes set-up, then the timed window, and prints the cell's
end-to-end metrics; ``--trace 1`` makes set-up, then one call under the
profiler, and prints the cell's per-layer metrics with ``busy_s``,
``window_s`` and a breakdown. Either way the outputs of the timed path are
then checked against the plain reference (``reference/``): every number
with a limit in the cell's limits file is compared and printed beside it,
last on standard error and last in the result line (a number without one
is printed as a reading). The last line of standard output is the result.

Exits 2 without a result where CUDA or the cell's cards are missing, and 3
where the process has loaded JAX or the JAX package once the window closed.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()   # the process's start, as near as the harness sees it

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Any, Dict, Optional  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CACHE = ROOT / ".portbench_cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "xiangqi_alphazero_tpu")


def _load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    bench: dict
    workload: dict
    cfg: dict
    traffic: dict
    limits: dict
    base: Path   # the directory of traffic/, limits/ and metrics/

    @property
    def name(self) -> str:
        return self.workload["name"]

    def end_to_end(self):
        return [m for m in self.bench["end_to_end"]
                if self.name in m.get("workloads", [self.name])]

    def per_layer(self):
        return [m for m in self.bench["per_layer"] if self.name in m["workloads"]]


def load_cell(workload: str, bench_path: Path = ROOT / "BENCHMARK.json") -> Cell:
    """The cell ``workload`` of ``bench_path``, with its files, which lie
    under the directory of ``bench_path`` (configurations by their ``file``,
    the rest under ``portbench/``)."""
    bench = _load_json(bench_path)
    root = bench_path.parent
    base = root / HERE.name
    cells = [w for w in bench["workloads"] if w["name"] == workload]
    if not cells:
        raise SystemExit(f"no workload {workload!r} in {bench_path}")
    unlisted = [m["name"] for m in bench["per_layer"] if "workloads" not in m]
    if unlisted:
        raise SystemExit(f"per-layer metrics without their workloads: {unlisted}")
    w = cells[0]
    conf = [c for c in bench["configs"] if c["name"] == w["config"]][0]
    limits_path = base / "limits" / f"{workload}.json"
    return Cell(bench, w, _load_json(root / conf["file"]),
                _load_json(base / "traffic" / f"{w['traffic']}.json"),
                _load_json(limits_path) if limits_path.exists() else {}, base)


def make_driver(cell: Cell, seed: int, device):
    module = importlib.import_module(f"portbench.drivers.{cell.traffic['driver']}")
    return module.Driver(cell.cfg, cell.traffic, seed, device)


@dataclasses.dataclass
class ReadContext:
    trace: Any
    counters: Dict[str, Any]
    cfg: dict
    traffic: dict
    peaks: Optional[dict]


def read_metric(name: str, ctx: ReadContext, base: Path) -> Optional[float]:
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}",
                                                  base / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(ctx)


def device_info(device, chips: int) -> dict:
    import torch

    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    peak = max(torch.cuda.max_memory_allocated(i) for i in range(chips))
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": int(peak)}


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else None
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t0: float = T0) -> dict:
    """Run the cell once on ``device``; returns the result line's dict."""
    import torch

    t_torch = time.perf_counter()
    if torch.device(device).type == "cuda":
        torch.empty(1, device=device)   # the CUDA context, timed on its own
    t_cuda = time.perf_counter()
    driver = make_driver(cell, seed, device)
    driver.setup()
    setup_s = time.perf_counter() - t0
    print(f"setup: to torch {t_torch - t0:.2f} s, CUDA context {t_cuda - t_torch:.2f} s, "
          f"the cell's set-up {t0 + setup_s - t_cuda:.2f} s", file=sys.stderr)
    metrics: Dict[str, dict] = {}
    extra: Dict[str, Any] = {}
    if trace:
        tr, counters = driver.traced()
        peaks = _load_json(HERE / "peaks.json").get(device_info(device, 1)["kind"])
        ctx = ReadContext(tr, counters, cell.cfg, cell.traffic, peaks)
        for m in cell.per_layer():
            v = read_metric(m["name"], ctx, cell.base)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        extra["device"] = {"busy_s": tr.busy_s(), "window_s": tr.window_s}
        extra["breakdown"] = {"device_ops": tr.top_ops(10), "idle_gaps": tr.idle_gaps(10)}
    else:
        values, counters = driver.window(seconds)
        values["setup_s"] = setup_s
        for m in cell.end_to_end():
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    dev = {**device_info(device, cell.workload["chips"]), **extra.get("device", {})}
    driver.release()
    t_check = time.perf_counter()
    numbers = driver.check()
    print(f"check {time.perf_counter() - t_check:.1f} s", file=sys.stderr)
    if not cell.limits:
        raise SystemExit(f"no limits for {cell.name}: nothing would be compared")
    compared, failed = {}, 0
    for name, value in numbers.items():
        if name not in cell.limits:   # read, but with no limit (PERF.md says why)
            print(f"reading {name} {value!r} (not compared)", file=sys.stderr)
            continue
        limit = cell.limits[name]["limit"]
        compared[name] = {"value": value, "limit": limit}
        failed += not value <= limit
    missing = set(cell.limits) - set(numbers)
    if missing:
        raise SystemExit(f"{cell.name}: the check read no {sorted(missing)}")
    out = {"correct": failed == 0, "attempted": counters["attempted"], "failed": failed,
           "metrics": metrics, "device": dev}
    if "breakdown" in extra:
        out["breakdown"] = extra["breakdown"]
    out["compared"] = compared
    return out


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    # every build and kernel cache at a fixed place inside the checkout
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    import torch

    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.workload["chips"]:
        print(f"portbench: needs {cell.workload['chips']} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda")
    found = forbidden_modules()
    if found:
        print(f"portbench: the process loaded {', '.join(found)}", file=sys.stderr)
        return 3
    print(f"portbench: {power_limit()}", file=sys.stderr)
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
