"""Run one cell of the benchmark of zultra_tpu_torch once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

(or ``python3 -m portbench.run ...``) from the root of a checkout, on a
machine with the CUDA cards the cell asks for; it refuses to run
without them. The cell's configuration, traffic mix and metrics are
found by the names in ``BENCHMARK.json``.

A run makes its inputs from the seed, warms up every shape its traffic
uses (set-up), then one caller calls the configuration's entry back to
back until ``--seconds`` have passed (the window), and last holds the
outputs against the plain reference (``check.py``). With ``--trace 1``
the window, at most ``TRACED_WINDOW_S`` long, runs under
``torch.profiler`` with the stage spans on, and the per-layer metrics
are read from them.

Standard output: an information line (card, power limit, calls,
captured graphs), then as its last line the JSON result. Standard error
ends with each compared number beside its limit.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if sys.path and Path(sys.path[0] or ".").resolve() == HERE:
    sys.path[0] = str(ROOT)  # run as a script: import the package, not its files
elif str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "zultra_tpu")
# The traced run's window is at most this long: the profiler's trace of a
# window of small calls grows by some 0.3 s of reading a traced call.
TRACED_WINDOW_S = 15.0


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one the port must not load."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def set_caches(root: Path) -> None:
    """Kernel caches at fixed paths inside the checkout."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(root / "build" / "portbench" / sub)


def card() -> tuple:
    """(name, power limit) of the first card, from nvidia-smi."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30).stdout
        name, limit = [x.strip() for x in out.splitlines()[0].split(",")][:2]
        return name, limit
    except (OSError, IndexError, ValueError, subprocess.SubprocessError):
        return None, None


def resolve(path: str):
    import importlib

    mod, _, attr = path.rpartition(".")
    return getattr(importlib.import_module(mod), attr)


def graphs(device) -> int | None:
    """Graphs the program holds on ``device`` (None on the CPU)."""
    if device.type != "cuda":
        return None
    try:
        from zultra_tpu_torch.ops import programs

        return len(programs.captured(device))
    except Exception:  # a program without the registry
        return None


def run_cell(workload: str, seed: int, seconds: float, traced: bool, device: str = "cuda",
             root: Path = ROOT, t_start: float = T0, workers: int = 0) -> tuple:
    """(result, info) of one run; the result is the last line's object."""
    import torch

    from portbench import check, devtrace, gen, spec
    from portbench.spans import Spans

    bench = spec.load(root)
    c = spec.cell(bench, workload, root)
    cfg = c["config_data"]
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if on_card else (lambda: None)
    entry = resolve(cfg["entry"])
    flags, mbs = int(cfg["flags"]), int(cfg["max_block_size"])

    def call(data):
        return entry(data, flags, mbs, device=dev)

    inputs, order = gen.make(json.loads(c["traffic_file"].read_text()), seed)
    for _ in range(2):  # the eager call, then the capture of every shape
        for i in order:
            call(inputs[i])
    sync()
    info = {"graphs_after_warmup": graphs(dev)}

    peak_before = torch.cuda.max_memory_reserved(dev) if on_card else 0
    spans = prof = None
    if traced:
        import torch.profiler as tp

        seconds = min(seconds, TRACED_WINDOW_S)
        import zultra_tpu_torch.device_pipeline as pipeline

        spans = Spans(pipeline, sync)
        spans.install()
        if on_card:
            torch.cuda.reset_peak_memory_stats(dev)
        acts = [tp.ProfilerActivity.CPU] + ([tp.ProfilerActivity.CUDA] if on_card else [])
        prof = tp.profile(activities=acts)
        prof.__enter__()
    calls, sent, outputs = [], [], []
    failed = 0
    w0 = time.perf_counter()
    setup_s = w0 - t_start
    with torch.profiler.record_function(devtrace.WINDOW):
        n = 0
        while True:
            i = order[n % len(order)]
            n += 1
            t0 = time.perf_counter()
            try:
                with torch.profiler.record_function(devtrace.CALL):
                    out = call(inputs[i])
                ok = True
            except Exception as exc:  # a failed call is counted, and the run goes on
                out, ok = None, False
                failed += 1
                print(f"portbench: call {n} failed: {exc!r}", file=sys.stderr)
            t1 = time.perf_counter()
            calls.append((t0, t1, len(inputs[i]), ok))
            sent.append(i)
            outputs.append(out)
            if t1 - w0 >= seconds:
                break
    window_s = calls[-1][1] - w0
    trace = None
    if prof is not None:
        t_stop = time.perf_counter()
        prof.__exit__(None, None, None)
        spans.remove()
        t_read = time.perf_counter()
        trace = devtrace.read(prof)
        del prof
        info.update(trace_stop_s=t_read - t_stop, trace_read_s=time.perf_counter() - t_read)
    peak_window = torch.cuda.max_memory_reserved(dev) if on_card else 0
    info["graphs_after_window"] = graphs(dev)

    kind = torch.cuda.get_device_name(dev) if on_card else "cpu"
    peaks = json.loads((HERE / "peaks.json").read_text()).get(kind)
    ctx = {"calls": calls, "window_s": window_s, "setup_s": setup_s, "device_kind": kind,
           "peaks": peaks, "trace": trace}
    if spans is not None:
        ctx.update(stage_s=dict(spans.seconds), dp_positions=spans.dp_positions,
                   peak_reserved_bytes=peak_window)
    metrics = {}
    for m in spec.metrics(bench, workload, traced):
        value = spec.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device = {"platform": "gpu" if on_card else "cpu", "kind": kind, "count": 1,
              "memory_peak_bytes": int(max(peak_before, peak_window))}
    result = {"correct": False, "attempted": len(calls), "failed": failed, "metrics": metrics,
              "device": device}
    if traced:
        device["busy_s"] = trace["busy_s"] if trace else 0.0
        device["window_s"] = trace["window_s"] if trace else window_s
        if trace:
            result["breakdown"] = {"device_ops": [[k, v] for k, v in trace["device_ops"][:10]],
                                   "idle_gaps": [[k, v] for k, v in trace["idle_gaps"][:10]]}
        done = sum(nb for _, _, nb, ok in calls if ok)
        info["MBps_traced"] = done / 1e6 / window_s if window_s > 0 else None
    times = sorted(t1 - t0 for t0, t1, _, ok in calls if ok)
    info.update(attempted=len(calls), completed=len(calls) - failed, window_s=window_s,
                call_ms={q: 1e3 * times[min(len(times) - 1, int(q / 100 * len(times)))]
                         for q in (0, 50, 90, 95, 99)} if times else None)

    if on_card:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = check.compare(inputs, sent, outputs, mbs, seed,
                            int(cfg["check"]["ref_windows"]), workers)
    info["check_s"] = time.perf_counter() - t_check
    result["correct"] = failed == 0 and all(v <= check.LIMITS[k] for k, v in numbers.items())
    result["compared"] = {k: {"value": v, "limit": check.LIMITS[k]} for k, v in numbers.items()}
    return result, info


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_caches(ROOT)
    from portbench import spec

    chips = int(spec.cell(spec.load(), args.workload)["chips"])
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: needs {chips} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    name, limit = card()
    result, info = run_cell(args.workload, args.seed % (1 << 64), args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 4
    info.update(card=name, power_limit=limit, workload=args.workload, seed=args.seed,
                trace=args.trace)
    print("portbench: " + json.dumps(info), flush=True)
    for k, v in result["compared"].items():
        print(f"{k} {v['value']} limit {v['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
