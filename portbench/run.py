"""One run of one cell of the port's benchmark, on this machine's card:

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (counted from the process's start): the port's kernel libraries
built or loaded from its cache inside the checkout (`rpt_tpu_torch/_build/`),
the cell's scene from the benchmark's own builder, one `Renderer`, one warm
frame (which compiles the scene and captures the sample's graph). Then
frames back to back through the renderer's public entry for `--seconds`;
then the check against the plain reference. The last line of standard
output is one JSON object; the compared numbers, each beside its limit, are
the last lines of standard error. A run without a CUDA card, or that finds
JAX or the JAX package loaded, exits nonzero and prints no result.
"""

from __future__ import annotations

import time

_T_IMPORT = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def process_start() -> float:
    """The process's start on the wall clock, from /proc (the import time
    of this module where /proc cannot say)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(int(line.split()[1]) for line in f if line.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration, IndexError):
        return _T_IMPORT


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def fail(msg: str) -> None:
    print(f"portbench: {msg}", file=sys.stderr)
    sys.exit(1)


def main(argv=None) -> None:
    t_start = min(process_start(), _T_IMPORT)
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    sys.path.insert(0, CHECKOUT)
    from portbench import guard, harness, registry

    bad = guard.loaded_forbidden() + guard.reference_imports(registry.PACKAGE)
    if bad:
        fail(f"forbidden modules before the run: {bad}")
    harness.set_cache_dirs()
    import torch

    cell = registry.workload(registry.benchmark(CHECKOUT), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        fail(f"the cell needs {cell['chips']} CUDA card(s); this machine has "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), CHECKOUT, "cuda", t_start)
    print(f"portbench: card {card_line()}", file=sys.stderr)
    forbidden = guard.loaded_forbidden()
    if forbidden:
        fail(f"forbidden modules loaded once the window closed: {forbidden}")
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
