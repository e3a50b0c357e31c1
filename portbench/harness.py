"""What every cell shares: finding a cell's files by name, the seeds, the
guards, the device record, the correctness verdict and the result line.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``.  Everything that
belongs to one configuration, traffic mix or metric is a file found by its
name, so a cell, a configuration or a metric is added by adding files:

* ``BENCHMARK.json`` ``configs[].file``: the configuration as it is run; its
  ``entry`` names the code that runs it, ``portbench/entries/<entry>.py``;
* ``portbench/traffic/<traffic>.json``: the drive (scene and noise);
* ``portbench/scenes/<scene>.py``: a scene's geometry (``build(**args)``);
* ``portbench/metrics/<metric>.py``: one reader per metric, end to end or
  per layer (``read(record) -> float | None``);
* ``portbench/limits/<cell>.json``: the limit of each number that decides
  ``correct``, with the readings it was set from.
"""

from __future__ import annotations

import importlib.util
import json
import math
import pathlib
import subprocess
import sys

import numpy as np

BENCH_DIR = pathlib.Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
# modules whose presence after the window fails the run, by whole top-level name
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "multimot_track_tpu")


class SpecError(ValueError):
    """A cell, configuration, traffic mix or metric that the files do not give."""


def load_json(path: pathlib.Path):
    with open(path) as f:
        return json.load(f)


def load_module(path: pathlib.Path, tag: str):
    """Import one file of the benchmark by its path (metric readers and
    entries: their names hold dots and dashes)."""
    if not path.is_file():
        raise SpecError(f"{path.relative_to(ROOT)} does not exist")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{tag}_" + "".join(c if c.isalnum() else "_" for c in path.stem), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One cell of ``BENCHMARK.json`` with every file it names, loaded."""

    def __init__(self, name: str, bench: dict = None, root: pathlib.Path = ROOT):
        self.root = pathlib.Path(root)
        self.bench_dir = self.root / "portbench"
        bench = bench if bench is not None else load_json(self.root / "BENCHMARK.json")
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise SpecError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
        self.name = name
        self.workload = cells[name]
        configs = {c["name"]: c for c in bench["configs"]}
        self.config = load_json(self.root / configs[self.workload["config"]]["file"])
        self.traffic = load_json(self.bench_dir / "traffic" / f"{self.workload['traffic']}.json")
        limits = self.bench_dir / "limits" / f"{name}.json"
        self.limits = load_json(limits) if limits.is_file() else None   # None: never correct
        self.chips = int(self.workload["chips"])
        self.e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
        self.per_layer = [m for m in bench["per_layer"] if _reports(m, name)]

    def entry(self):
        return load_module(self.bench_dir / "entries" / f"{self.config['entry']}.py", "entry")

    def scene(self, **overrides):
        mod = load_module(self.bench_dir / "scenes" / f"{self.traffic['scene']}.py", "scene")
        return mod.build(**{**self.traffic.get("scene_args", {}), **overrides})

    def reader(self, metric: dict):
        return load_module(self.bench_dir / "metrics" / f"{metric['name']}.py", "metric")


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def derive_seed(seed: int, *tags) -> int:
    """A 63-bit seed for one use of ``--seed`` (any whole number >= 0, also
    past 32 bits): the same (seed, tags) give the same number."""
    words = [int(seed) & 0xFFFFFFFF, (int(seed) >> 32) & 0xFFFFFFFF]
    for t in tags:
        words += [int(t)] if isinstance(t, int) else list(str(t).encode())
    return int(np.random.SeedSequence(words).generate_state(2, np.uint64)[0] >> np.uint64(1))


# ---------------------------------------------------------------------------
# arithmetic of the end-to-end metrics

def nearest_rank(values, q: float) -> float:
    """The q-quantile by nearest rank: the smallest value with at least
    q of all values at or below it (an element of ``values``)."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    return float(v[max(0, math.ceil(q * len(v)) - 1)])


# ---------------------------------------------------------------------------
# guards and the device record

def cuda_or_exit(chips: int):
    """Exit 2, printing no result, unless ``chips`` CUDA devices are there."""
    import torch

    if not torch.cuda.is_available():
        sys.exit("portbench: no CUDA device; this benchmark runs only on the card")
    if torch.cuda.device_count() < chips:
        sys.exit(f"portbench: the cell needs {chips} CUDA devices, "
                 f"{torch.cuda.device_count()} found")


def forbidden_modules():
    """Loaded modules whose top-level name is one of FORBIDDEN_MODULES."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN_MODULES))


def power_limit_w():
    """The card's power limit as ``nvidia-smi`` prints it, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=True).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return None
    return out[0].split(",")[-1].strip() if out else None


def device_record(chips: int, power_limit) -> dict:
    import torch

    return {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": chips,
        "memory_peak_bytes": max(int(torch.cuda.max_memory_allocated(d))
                                 for d in range(chips)),
        "power_limit": power_limit,
    }


# ---------------------------------------------------------------------------
# the verdict

def verdict(numbers: dict, limits: dict):
    """(correct, [[name, number, limit], ...]): every number at or under its
    limit.  A number that is missing or not finite fails."""
    rows, ok = [], True
    for name, spec in limits["numbers"].items():
        v = numbers.get(name)
        lim = float(spec["limit"])
        good = v is not None and math.isfinite(v) and v <= lim
        ok = ok and good
        rows.append([name, v if v is None or math.isfinite(v) else str(v), lim])
    return ok, rows
