"""Run one cell of the benchmark once and print its result line.

    python3 -m frame_bench.run --workload <cell> --seed <n> \\
        --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``.  Needs as many
CUDA cards as the cell asks for: without them it exits 2 and prints no
result; it never falls back to the CPU.

Set-up (``setup_s``, from this module's first line to the first timed
frame): import torch and the port, make the scene from the seed, fit the
capacities, build the frame step (the kernels' library, built into
``build/piet_tpu_torch/`` of the checkout on the checkout's first run, and
the CUDA graph), and warm up.  ``--trace 0`` then runs the closed loop
(``loop.py``) for ``--seconds`` and reports the cell's end-to-end metrics;
``--trace 1`` runs a slice of the same loop with the port's call timed by
the host's clock, then a slice under torch.profiler (the trace goes to a
temporary file and is deleted once read), and reports the per-layer
metrics, ``device.busy_s``/``window_s`` and a ``breakdown``.

After the loop the program's state is freed and the kept frames are
compared with the frozen oracle (``check.py``).  The last stdout line is
the JSON result; the numbers compared, each beside its limit, are the
last lines of stderr and the result's last key, ``checks``.  The run
exits 3, printing no result, if JAX, jaxlib, flax or the JAX package was
loaded.  Every child process is waited for before the result is
printed: one still there then (none is expected) is named on stderr,
stopped and waited for.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import signal  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "piet_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (compared whole: ``piet_tpu_torch`` is the port)."""
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def child_pids() -> list:
    """The pids of this process's child processes that have not been
    waited for (Linux's ``/proc``; empty elsewhere)."""
    pids = set()
    for f in Path(f"/proc/{os.getpid()}/task").glob("*/children"):
        try:
            pids.update(int(x) for x in f.read_text().split())
        except OSError:
            pass
    return sorted(pids)


def stop_children(grace_s: float = 5.0) -> list:
    """Stop and wait for every child process still there: SIGTERM, then
    SIGKILL after ``grace_s``.  Returns the command lines found, which
    name a process that some step left behind."""
    found = {}
    for pid in child_pids():
        try:
            found[pid] = Path(f"/proc/{pid}/cmdline").read_bytes().replace(
                b"\0", b" ").decode(errors="replace").strip()
            os.kill(pid, signal.SIGTERM)
        except OSError:
            pass
    deadline = time.monotonic() + grace_s
    for pid in found:
        while True:
            try:
                done, _ = os.waitpid(pid, os.WNOHANG)
            except ChildProcessError:
                break
            if done:
                break
            if time.monotonic() > deadline:
                os.kill(pid, signal.SIGKILL)
                os.waitpid(pid, 0)
                break
            time.sleep(0.01)
    return list(found.values())


def card_readings(device: int = 0) -> dict:
    """nvidia-smi's power limit, SM clock (now and its maximum), power
    draw and temperature of card ``device``; an empty dict where it cannot
    read them."""
    keys = ("power.limit", "clocks.sm", "clocks.max.sm", "power.draw",
            "temperature.gpu")
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=" + ",".join(keys),
             "--format=csv,noheader,nounits", f"--id={device}"],
            capture_output=True, text=True, timeout=30, check=True).stdout
        vals = [float(v) for v in out.strip().splitlines()[0].split(",")]
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return {}
    return dict(zip(keys, vals))


def _short(name: str) -> str:
    """A kernel's name without its argument list."""
    if name.endswith(")"):
        depth = 0
        for k in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[k], 0)
            if depth == 0:
                name = name[:k]
                break
    return name.strip()[:160]


def run_cell(c: dict, seed: int, seconds: float, trace: bool, device,
             t0: float, workers: int = 0) -> dict:
    """One run of cell ``c`` (``spec.cell``) on ``device``: the result
    line's keys, without ``device``'s card fields."""
    import torch

    from . import check, loop
    from . import trace as tr
    from .spec import metric_module
    from .workload import make_workload

    traffic = c["traffic"]
    t_imported = time.perf_counter()
    wl = make_workload(c["config"], traffic, seed, device)
    t_built = time.perf_counter()
    keeper = loop.Keeper(check.compare_poses(wl.n_poses, seed))
    i = 0
    for _ in range(int(traffic.get("warmup_frames", 3))):
        wl.finish(wl.frame(i))
        i += 1
    if wl.device.type == "cuda":
        torch.cuda.synchronize(wl.device)
    t_warm = time.perf_counter()
    setup_s = t_warm - t0
    print(f"setup s: imports {t_imported - t0:.4f} workload "
          f"{t_built - t_imported:.4f} warm-up {t_warm - t_built:.4f}",
          file=sys.stderr)

    metrics, out = {}, {}
    if not trace:
        res = loop.window(wl, seconds, keeper, first=i)
        attempted, n_failed = res["attempted"], res["failed"]
        e2e = {"frame_ms": 1e3 * res["window_s"] / max(res["completed"], 1),
               "frame_p95_ms": loop.p95(res["latency_ms"]),
               "setup_s": setup_s}
        for m in c["end_to_end"]:
            # "frame_ms.rebuild" is frame_ms under a bound of its own.
            metrics[m["name"]] = {"value": e2e[m["name"].split(".")[0]],
                                  "unit": m["unit"]}
        n = len(res["latency_ms"])
        tenths = [res["latency_ms"][n * k // 10:n * (k + 1) // 10]
                  for k in range(10)]
        print("mean latency ms by tenth of the window: " + " ".join(
            f"{sum(t) / len(t):.4f}" for t in tenths if t), file=sys.stderr)
        lat = sorted(res["latency_ms"])
        print(f"latency ms: min {lat[0]:.4f} median {lat[len(lat) // 2]:.4f}"
              f" mean {sum(lat) / len(lat):.4f} p95 {loop.p95(lat):.4f}"
              f" max {lat[-1]:.4f} frames {len(lat)}", file=sys.stderr)
        ctx = None
    else:
        hs = loop.host_spans(wl, int(traffic["host_frames"]), keeper, first=i)
        fd, path = tempfile.mkstemp(prefix="frame_bench_", suffix=".json")
        os.close(fd)
        try:
            tres = loop.traced(wl, int(traffic["trace_frames"]), keeper, path,
                               first=hs["next"])
            reduced = tr.reduce(tr.load(path))
        finally:
            os.unlink(path)
        attempted = int(traffic["host_frames"]) + int(traffic["trace_frames"])
        n_failed = hs["failed"] + tres["failed"]
        ctx = dict(reduced, host_call_s=hs["host_call_s"],
                   untraced_frame_s=hs["frame_s"])
        out["busy_s"] = reduced["busy_s"]
        out["window_s"] = reduced["window_s"]
        out["breakdown"] = {
            "device_ops": tr.top((_short(n), d)
                                 for n, _, d in reduced["device"]),
            "idle_gaps": tr.top(reduced["gaps"])}

    card = {}
    if wl.device.type == "cuda":
        card = card_readings(wl.device.index or 0)
        print("card after the loop: " + ", ".join(
            f"{k} {v}" for k, v in card.items()), file=sys.stderr)
    peak = (torch.cuda.max_memory_allocated(wl.device)
            if wl.device.type == "cuda" else 0)
    images = {p: check.rgba8(wl.image(o).cpu().numpy())
              for p, o in keeper.kept.items()}
    scenes = {p: wl.reference_scene(p)
              for p in (keeper.poses if keeper.poses is not None
                        else [wl.pose(0)])}
    cfg = wl.cfg
    wl.close()
    del keeper
    if wl.device.type == "cuda":
        torch.cuda.empty_cache()
    checks, ptcl = check.check(images, scenes, cfg, workers=workers)

    if ctx is not None:
        from .metrics.fine_roofline import peaks_for
        kind = (torch.cuda.get_device_name(wl.device)
                if wl.device.type == "cuda" else "cpu")
        ctx.update(ptcl=ptcl, peaks=peaks_for(kind), geometry={
            "width": cfg.width, "height": cfg.height,
            "tile_width": cfg.tile_width, "tile_height": cfg.tile_height,
            "tiles_x": cfg.tiles_x})
        for m in c["per_layer"]:
            v = metric_module(m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    return {"correct": all(v["value"] <= v["limit"]
                           for v in checks.values()),
            "attempted": attempted, "failed": n_failed, "metrics": metrics,
            "memory_peak_bytes": int(peak), "checks": checks,
            "power_limit_w": card.get("power.limit"), **out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m frame_bench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from .spec import cell, load_benchmark
    c = cell(load_benchmark(Path.cwd()), args.workload)
    chips = int(c["entry"]["chips"])
    try:
        import torch
        import piet_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"frame_bench: cannot import the program: {e}",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"frame_bench: {args.workload} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2

    try:
        res = run_cell(c, args.seed, args.seconds, bool(args.trace),
                       "cuda:0", T0)
    finally:
        left = stop_children()
        if left:
            print("frame_bench: stopped processes left running: "
                  + "; ".join(left), file=sys.stderr)
    found = forbidden_modules()
    if found:
        print(f"frame_bench: loaded {', '.join(found)}: the run may not "
              f"load JAX or the JAX package", file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips, "memory_peak_bytes": res["memory_peak_bytes"],
              "power_limit_w": res["power_limit_w"]}
    if args.trace:
        device.update(busy_s=res["busy_s"], window_s=res["window_s"])
    line = {"correct": res["correct"], "attempted": res["attempted"],
            "failed": res["failed"], "metrics": res["metrics"],
            "device": device}
    if "breakdown" in res:
        line["breakdown"] = res["breakdown"]
    line["checks"] = res["checks"]
    sys.stdout.flush()
    for name, v in res["checks"].items():
        print(f"check {name} {v['value']} limit {v['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
