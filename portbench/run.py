"""The benchmark of capsaicin_tpu_torch (the PyTorch and CUDA renderer) on
one CUDA card:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. A cell is an entry of BENCHMARK.json's
"workloads"; its configuration, traffic mix, metrics and limits are files
under portbench/ found by name (README.md). Prints the card, its power
limit, the memory peak and the kernel launches on earlier lines, each
compared number beside its limit as the last lines of standard error, and
one JSON object as the last line of standard output. Exits non-zero
without a result where no CUDA card is present, where the program or a
file of the cell is missing, or where JAX or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import sys
import time
from types import SimpleNamespace


def _age_at_start() -> float:
    """Seconds since this process started (0 where /proc cannot say)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


AGE, T_IMPORT = _age_at_start(), time.perf_counter()
BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
REPO_DIR = os.path.dirname(BENCH_DIR)
NOISE_PATH = os.path.join(REPO_DIR, "assets", "textures", "bluenoise256.npy")
FORBIDDEN = ("jax", "jaxlib", "flax", "capsaicin_tpu")


def forbidden_modules() -> list:
    """Modules loaded in this process whose top-level name is JAX's or the
    JAX package's (whole names: capsaicin_tpu_torch is not capsaicin_tpu)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def steady_host_allocator():
    """Keep freed host blocks of up to 32 MiB in the heap (glibc's mallopt:
    the mmap threshold at its 32 MiB maximum, the trim threshold at 1 GiB),
    so that each frame's 24 MB display readback reuses resident pages. With
    glibc's adaptive defaults a process either reuses them or maps and
    faults them in afresh every frame, by the accident of its heap layout,
    and the readback then reads 2 or 7-10 ms a frame by process."""
    try:
        libc = ctypes.CDLL("libc.so.6")
    except OSError:
        return
    m_trim_threshold, m_mmap_threshold = -1, -3
    libc.mallopt(m_mmap_threshold, 32 << 20)
    libc.mallopt(m_trim_threshold, 1 << 30)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, REPO_DIR)
    os.environ["USE_FLAX"] = "0"
    steady_host_allocator()

    from portbench.lib import cells

    cell = cells.resolve(args.workload, cells.load_benchmark())
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: the cell needs {cell.chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda")
    bad = forbidden_modules()
    if bad:
        print(f"portbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['ok'] else 'FAILED'}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


def window_summary(record: dict) -> dict:
    """The window's length and its latencies for the record: every one
    where there are few (a request each), else their quantiles. A stall of
    the host shows as one latency far above the rest; a slower card as all
    of them above another run's."""
    lat = sorted(record["latencies_s"])
    out = {"window_s": record["window_s"], "frames": record["frames"], "latencies": len(lat)}
    if len(lat) <= 64:
        out["latencies_s"] = record["latencies_s"]
    elif lat:
        out.update({f"q{q}_s": lat[min(len(lat) - 1, len(lat) * q // 100)]
                    for q in (0, 50, 95, 99)}, max_s=lat[-1])
    return out


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str, size=None,
             scene_overrides=None, option_overrides=None) -> dict:
    """One run of `cell`: set-up, the window, the metrics and the check.
    Returns the result object. `size`, `scene_overrides` and
    `option_overrides` serve the tests and the readings of the limits."""
    import torch

    from portbench.lib import cells, check
    from portbench.lib import device as device_lib
    from portbench.lib.bench import Bench

    bench = Bench(cell, device, size=size, scene_overrides=scene_overrides,
                  option_overrides=option_overrides)
    bench.setup()
    bench.warm()
    record = bench.window(seed, seconds, trace)
    setup_s = AGE + (bench.t_start - T_IMPORT)
    print("portbench: set-up " + json.dumps(
        {"setup_s": setup_s, "before_import_s": AGE, **bench.setup_steps}), file=sys.stderr)
    print("portbench: window " + json.dumps(window_summary(record)), file=sys.stderr)
    dev = {"platform": "cpu", "kind": "cpu", "count": 1}
    if device == "cuda":
        dev = device_lib.describe(torch, cell.chips)
        dev["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated())
        print(f"portbench: device {dev['kind']} x{dev['count']}, power limit "
              f"{device_lib.power_limit()}, memory peak {dev['memory_peak_bytes']} bytes",
              file=sys.stderr)
    from capsaicin_tpu_torch import kernels

    print("portbench: kernel launches " + json.dumps(
        {k.name: k.launches for k in kernels.REGISTRY}), file=sys.stderr)
    run = SimpleNamespace(cell=cell, config=bench.config, options=bench.options,
                          record=record, trace=bench.trace, setup_s=setup_s,
                          width=bench.width, height=bench.height)
    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = cells.reader(m["name"])(run)
        if value is None and not trace:
            raise RuntimeError(f"end-to-end metric {m['name']} has no value in {cell.name}")
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": False, "attempted": record.get("requests", record["frames"]),
              "failed": 0, "metrics": metrics, "device": dev}
    if trace and bench.trace is not None:
        from capsaicin_tpu_torch.render import pipeline

        t = bench.trace
        dev.update(busy_s=t.busy_s, window_s=t.wall_s)
        result["breakdown"] = {"device_ops": t.top_kernels(10),
                               "idle_gaps": t.idle_gaps(pipeline.PASS_NAMES, 10)}
    outputs = [image for _, image in getattr(bench, "requests", [])]
    if bench.interactive:
        outputs = [bench.start[1], bench.step[2]]
    result["failed"] = sum(int(not bool(torch.isfinite(torch.from_numpy(o)).all()))
                           for o in outputs)
    limits = check.limits_of(cell.name)
    bench.collect(seed, limits)
    bench.release()
    t0 = time.perf_counter()
    numbers = bench.check(limits, NOISE_PATH)
    print(f"portbench: the reference's check took {time.perf_counter() - t0:.3f} s",
          file=sys.stderr)
    checks = check.judge(numbers, limits)
    result["correct"] = result["failed"] == 0 and all(c["ok"] for c in checks.values())
    result["checks"] = checks
    return result


if __name__ == "__main__":
    raise SystemExit(main())
