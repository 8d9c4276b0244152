"""Run one cell of BENCHMARK.json on the card and print its result.

    python3 darthbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics with ``--trace 0``, its per-layer ones with
``--trace 1``), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``: each number the check compared, with its limit. The same
numbers are the last lines of standard error; everything else a run
reports (set-up split, launches, lags, recall per target) comes before
them there.

The run exits non-zero and prints no result when there is no CUDA card
(or fewer than the cell asks for), when the program cannot be imported,
or when JAX, flax or the JAX package is loaded once the window closes.
"""
from __future__ import annotations

import time

T0 = time.time()   # set-up is counted from here, before the imports

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def environment() -> None:
    """Caches inside the checkout at fixed paths; few host threads."""
    cache = ROOT / "build" / "darthbench"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_ext"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                "OPENBLAS_NUM_THREADS"):
        os.environ.setdefault(var, "4")
    # Run as a script, Python puts this directory first on the path, where
    # its modules would shadow top-level names; the package is imported
    # from the checkout root instead.
    sys.path[:] = [p for p in sys.path
                   if not p or pathlib.Path(p).resolve() != HERE]
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def loaded_forbidden() -> list:
    """Top-level names of loaded modules that the run must not hold,
    compared whole (``repro_torch`` is not ``repro``)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def card_state(fields: str = "name,power.limit") -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={fields}",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def report(result: dict) -> None:
    """The checks as the last lines of standard error, then the result as
    the last line of standard output."""
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)


def main(argv=None) -> int:
    args = parse(argv)
    environment()
    try:
        import torch
        import repro_torch  # noqa: F401  (the program under test)
    except ImportError as e:
        print(f"darthbench: cannot import the program: {e}", file=sys.stderr)
        return 2
    from darthbench import bench, manifest

    chips = int(manifest.cell(manifest.load(ROOT), args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"darthbench: the cell needs {chips} CUDA card(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}", file=sys.stderr)
        return 3
    bench.log(f"card: {card_state()}; torch {torch.__version__}, "
              f"CUDA {torch.version.cuda}")
    result = bench.execute(ROOT, args.workload, args.seed, args.seconds,
                           bool(args.trace), "cuda:0", T0)
    bench.log("card after the run: " + card_state(
        "clocks.sm,clocks.mem,temperature.gpu,power.draw"))
    found = loaded_forbidden()
    if found:
        print(f"darthbench: loaded in the run's process: {found}",
              file=sys.stderr)
        return 4
    report(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
