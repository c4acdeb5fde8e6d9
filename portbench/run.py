"""The port's benchmark: one run of one cell of `BENCHMARK.json`.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout with a CUDA card. A run makes its data from the
seed, loads it into the port (`repro_torch`, from `src/`), warms the
cell's own queries, then drives the cell's traffic mix for
`--seconds`. The set-up time, `setup_s`, runs from the start of the process
to the opening of the window. After the window the port's state is freed
and the answers (a sample drawn from the seed) are held against the plain
reference; the numbers compared go to standard error,
each beside its limit, as the last lines there.

The last line of standard output is the result: with `--trace 0` the
cell's end-to-end metrics, with `--trace 1` its per-layer metrics from a
torch.profiler trace of the window, with a `breakdown` of the device's
busiest operations and of its idle time by what the host was doing.

`--control` puts the control in the port's place (the reference with
each answer cut at the mix's `control_cap` rows); its `correct` has to
come out false. Measured runs never pass it.

A run exits with a code other than 0 and prints no result where it finds
no card or fewer cards than the cell asks for, cannot import the port, or
finds JAX or the JAX package (`repro`) loaded after its set-up or after
its window.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name (before the first dot) is JAX's
    or the JAX package's, compared whole (`repro_torch` is not `repro`)."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None
                                       else modules)}
    return sorted(names & set(FORBIDDEN))


class Refused(Exception):
    """A run that must print no result."""


def guard(when: str) -> None:
    bad = forbidden_modules()
    if bad:
        raise Refused(f"modules of JAX or the JAX package loaded {when}: "
                      f"{', '.join(bad)}")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true")
    return ap.parse_args(argv)


def caches_inside(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout (the
    port's own kernels go to `build/kernels/`, fixed in its code)."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")


def run(args, device: str = "cuda", cell=None) -> dict:
    """One run; the result's JSON object. `device` "cpu" (and a `cell`
    made by hand) is for the CPU tests of the harness: the port's plain
    paths, no trace, no device numbers."""
    from portbench import check, devtrace, layers, manifest, sut
    from portbench import window as win

    if cell is None:
        cell = manifest.resolve(manifest.load_manifest(), args.workload)
    caches_inside(manifest.ROOT)
    import torch
    on_card = device == "cuda"
    if on_card and not torch.cuda.is_available():
        raise Refused("no CUDA device: the benchmark measures the card")
    if on_card and torch.cuda.device_count() < cell.chips:
        raise Refused(f"{cell.name} needs {cell.chips} cards, this host has "
                      f"{torch.cuda.device_count()}")
    if args.trace and not on_card:
        raise Refused("a traced run reads the card's trace")
    torch.set_num_threads(4)
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    device_name = torch.cuda.get_device_name(0) if on_card else "cpu"
    graph = manifest.generator(cell.config["schema"]).generate(cell.config,
                                                               args.seed)
    print(f"[setup] {cell.name}: {len(graph.triples):,} triples, "
          f"{graph.n_terms:,} terms ({time.perf_counter() - T_START:.3f} s)",
          file=sys.stderr)
    spans = devtrace.Spans(args.trace == 1)
    control = check.Reference(graph) if args.control else None
    loop = manifest.kind(cell.traffic["kind"]).Loop(
        cell, graph, args.seed, device, spans, control)
    if control is None and on_card:
        sut.build_kernels_for_queries()
    t_warm = time.perf_counter()
    loop.setup()
    sync()
    print(f"[setup] load and warm-up {time.perf_counter() - t_warm:.3f} s",
          file=sys.stderr)
    guard("after set-up")
    setup_s = time.perf_counter() - T_START
    print(f"[setup] {setup_s:.3f} s", file=sys.stderr)

    if args.trace:
        with devtrace.DeviceTrace(torch) as trace:
            window = loop.run(args.seconds)
    else:
        window = loop.run(args.seconds)
    guard("after the window")
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0

    metrics = {}
    breakdown = None
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    if args.trace:
        ctx = layers.Context(torch, window, trace, loop, device_name)
        for m in cell.per_layer:
            value = manifest.reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = value
        breakdown = trace.breakdown(spans.items)
        device_extra = {"busy_s": trace.busy_s(), "window_s": trace.window_s}
        del ctx                           # it holds the port's state
    else:
        e2e = win.end_to_end(window)
        e2e["setup_s"] = setup_s
        metrics = {m["name"]: e2e[m["name"]] for m in cell.end_to_end}
        device_extra = {}

    loop.close()
    del loop
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    ref = control if control is not None else check.Reference(graph)
    numbers = check.judge(window.requests, ref,
                          cell.traffic.get("check_sample"), args.seed)
    guard("after the check")
    result = {
        "correct": check.verdict(numbers),
        "attempted": len(window.requests),
        "failed": window.failed(),
        "metrics": {k: {"value": v, "unit": units[k]}
                    for k, v in metrics.items()},
        "device": {"platform": "gpu", "kind": device_name, "count": cell.chips,
                   "memory_peak_bytes": memory_peak, **device_extra},
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": numbers[k], "limit": lim}
                        for k, lim in check.LIMITS.items()}
    print(f"[check] {numbers['compared']} answers held against the "
          f"reference", file=sys.stderr)
    for k, lim in check.LIMITS.items():
        print(f"{k} {numbers[k]} limit {lim}", file=sys.stderr)
    return result


def main(argv=None) -> int:
    args = parse_args(argv)
    try:
        result = run(args)
    except Refused as e:
        print(f"refused: {e}", file=sys.stderr)
        return 2
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
