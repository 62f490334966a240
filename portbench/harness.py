"""The benchmark's frame: the manifest, the files a cell is made of, the
device check, the comparison's verdict and the result line.

Everything a cell needs is found by name: its entry in ``BENCHMARK.json``
names a configuration (``configs/<file>``, from the manifest's ``file``)
and a traffic mix (``traffic/<name>.json``), whose ``kind`` names the
driver (``drivers/<kind>.py``); the limits of its comparison are
``limits/<workload>.json``, and each per-layer metric is read by
``metrics/<metric>.py``.  A cell, a configuration, a traffic mix or a
metric is added as files and entries, with no file here edited.
"""
from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# module names a run may not hold once its window has closed: JAX and the
# JAX package, compared by the name before the first dot
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class Refused(Exception):
    """A run that prints no result (no card, a file missing, a forbidden
    import)."""


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str | None = None):
    """A file of the benchmark as a module (its name need not be a Python
    identifier)."""
    name = name or "portbench_" + "".join(
        c if c.isalnum() else "_" for c in f"{path.parent.name}/{path.stem}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def manifest(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell(workload: str, root: Path = ROOT) -> dict:
    """Everything one cell is made of: its manifest entry, its
    configuration, traffic mix and limits, and its metrics by kind."""
    man = manifest(root)
    entry = {w["name"]: w for w in man["workloads"]}.get(workload)
    if entry is None:
        raise Refused(f"no workload {workload!r} in BENCHMARK.json")
    cfg_entry = {c["name"]: c for c in man["configs"]}[entry["config"]]
    bench = root / "portbench"
    traffic = load_json(bench / "traffic" / f"{entry['traffic']}.json")
    limits_path = bench / "limits" / f"{workload}.json"
    return {
        "workload": entry,
        "config": load_json(root / cfg_entry["file"]),
        "config_name": cfg_entry["name"],
        "traffic": traffic,
        "limits": load_json(limits_path) if limits_path.exists() else {},
        "end_to_end": [m for m in man["end_to_end"] if workload in
                       m.get("workloads", [workload])],
        "per_layer": [m for m in man["per_layer"] if workload in
                      m.get("workloads", [workload])],
        "bench": bench,
    }


def driver(kind: str, bench: Path = BENCH):
    return load_module(bench / "drivers" / f"{kind}.py")


def reader(metric: str, bench: Path = BENCH):
    return load_module(bench / "metrics" / f"{metric}.py")


def require_cards(chips: int) -> None:
    """Refuse a run without as many CUDA cards as the cell asks for."""
    import torch
    if not torch.cuda.is_available():
        raise Refused("no CUDA device: the benchmark measures the card")
    if torch.cuda.device_count() < chips:
        raise Refused(f"the cell asks for {chips} cards, "
                      f"{torch.cuda.device_count()} found")


def forbidden_modules(modules=None) -> list:
    mods = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in mods
                   if m.split(".")[0] in FORBIDDEN})


def verdict(numbers: dict, limits: dict) -> tuple:
    """(correct, compared): each number beside its limit; a number above
    its limit, not finite, or without a limit is not correct."""
    compared, ok = {}, True
    for name, value in numbers.items():
        limit = limits.get(name)
        good = (limit is not None and value is not None
                and math.isfinite(value) and value <= limit)
        ok = ok and good
        compared[name] = {"value": value, "limit": limit}
    return ok and bool(numbers), compared


def per_layer(c: dict, run: dict) -> dict:
    """Each per-layer metric of the cell that its reader finds something
    to read for; a reader that finds nothing returns None and the metric
    is left out."""
    out = {}
    for m in c["per_layer"]:
        value = reader(m["name"], c["bench"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def end_to_end(c: dict, values: dict) -> dict:
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in c["end_to_end"]}


def device_info(count: int, peak_bytes: int, trace=None,
                device="cuda") -> dict:
    import torch
    gpu = torch.device(device).type == "cuda"
    dev = {"platform": "gpu" if gpu else "cpu",
           "kind": torch.cuda.get_device_name(0) if gpu else "cpu",
           "count": count, "memory_peak_bytes": int(peak_bytes)}
    if trace is not None:
        dev["busy_s"] = trace["busy_s"]
        dev["window_s"] = trace["window_s"]
    return dev


def emit(result: dict, compared: dict) -> None:
    """The numbers compared as the last lines of standard error, then the
    result as the last line of standard output, `compared` its last key."""
    for name, c in compared.items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps({**result, "compared": compared}))
    sys.stdout.flush()


def cache_env() -> None:
    """Build and kernel caches inside the checkout, at fixed paths."""
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


class Readings:
    """What the per-layer readers read: the traced window's summary
    (``trace.reduce_events``) and the driver's counts over it."""

    def __init__(self, trace: dict | None, counts: dict | None):
        self.trace = trace or {}
        self.counts = counts or {}

    def phase(self, p: str):
        ph = self.trace.get("phases", {}).get(p)
        return ph if ph and ph["span_s"] > 0 else None

    def idle_share(self, p: str):
        """The share of the phase's spans in which no device operation
        ran, %."""
        ph = self.phase(p)
        return None if ph is None else 100.0 * (1 - ph["busy_s"]
                                                / ph["span_s"])

    def mfu(self, p: str, peak_ops_per_s: float):
        """The plain model's operations over the phase's time at the
        peak, %."""
        ph, ops = self.phase(p), self.counts.get("plain_ops", {}).get(p)
        if ph is None or not ops:
            return None
        return 100.0 * ops / (ph["span_s"] * peak_ops_per_s)

    def roofline(self, p: str):
        """The ring matmuls' bound over their device time in the phase,
        %; nothing where no ring matmul ran there."""
        ph = self.phase(p)
        bound = self.counts.get("ring_matmul_bound_s", {}).get(p)
        if ph is None or not bound or ph["ring_matmul_device_s"] <= 0:
            return None
        return 100.0 * bound / ph["ring_matmul_device_s"]

    def ops_per(self, p: str, unit: str):
        ph, n = self.phase(p), self.counts.get(unit, {}).get(p)
        return None if ph is None or not n else ph["device_ops"] / n

    def mbit_per(self, p: str, unit: str):
        bits = self.counts.get("online_bits", {}).get(p)
        n = self.counts.get(unit, {}).get(p)
        return None if bits is None or not n else bits / n / 1e6

    def mean_ms(self, key: str):
        xs = self.counts.get(key)
        return None if not xs else 1e3 * sum(xs) / len(xs)


def run_cell(c: dict, seed: int, seconds: float, trace: bool, device,
             t_start: float) -> tuple:
    """Run the cell's driver; (result, compared)."""
    out = driver(c["traffic"]["kind"], c["bench"]).run(
        c, seed, seconds, trace, device, t_start)
    correct, compared = verdict(out["numbers"], c["limits"])
    chips = c["workload"]["chips"]
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"]}
    if trace:
        t = out["trace"]
        print(f"trace: window {t['window_s']:.6f} s, busy {t['busy_s']:.6f} s,"
              f" {t['device_ops']} device ops, "
              f"{t['unlinked_device_ops']} not linked to a launch",
              file=sys.stderr)
        result["metrics"] = per_layer(c, Readings(out["trace"],
                                                  out["counts"]))
        result["device"] = device_info(chips, out["peak"], out["trace"],
                                       device)
        result["breakdown"] = out["trace"]["breakdown"]
    else:
        result["metrics"] = end_to_end(c, out["values"])
        result["device"] = device_info(chips, out["peak"], None, device)
    return result, compared
