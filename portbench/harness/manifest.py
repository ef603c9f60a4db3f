"""``BENCHMARK.json`` and the files it names.

Everything that belongs to one configuration, traffic mix, metric,
reference or kernel's roofline is a file of its own, found by name:

* ``configs/<config>.json`` (the path is the ``file`` of its entry),
* ``traffic/<traffic>.json``, whose ``phantom`` is of a kind that
  ``traffic/phantoms.py`` makes itself (``BUILT_IN_KINDS``) or that
  ``traffic/kinds/<kind>.py`` makes with ``make(phantom, shape_zyx,
  voxel_width, seed, device) -> (volume, mask or None)``,
* ``metrics/<metric>.py`` with ``read(ctx) -> float | None``,
* ``references/<config>.py`` with ``check`` and ``control``,
* ``roofline/<kernel>.py`` with ``KERNEL``, ``LAUNCHES`` and ``work``.

A later change adds a cell, a metric or a kernel by adding such files
and entries; it edits none of the files here."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import re
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
BUILT_IN_KINDS = ("membrane", "blob")


def load_json(path: str) -> Dict:
    with open(path) as fh:
        return json.load(fh)


def load_module(path: str, name: str):
    """The Python file ``path`` as a module named ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kind_path(kind: str) -> str:
    """The file of a phantom kind that is not built in."""
    return os.path.join(HERE, "traffic", "kinds", f"{kind}.py")


def phantom_kinds(phantom: Dict) -> List[str]:
    """The kind of a traffic's phantom and of every phantom nested in
    it (a value that is itself a dict with a ``kind``)."""
    out = [phantom["kind"]]
    for v in phantom.values():
        if isinstance(v, dict) and "kind" in v:
            out += phantom_kinds(v)
    return out


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    traffic: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]
    root: str

    def metric_reader(self, name: str):
        return load_module(os.path.join(HERE, "metrics", f"{name}.py"),
                           f"portbench_metric_{name.replace('.', '_')}")

    def reference(self):
        name = self.config["reference"]
        return load_module(os.path.join(HERE, "references", f"{name}.py"),
                           f"portbench_reference_{name}")


def _applies(metric: Dict, cell: str, reported: set) -> bool:
    """A per-layer metric is read in the cells it lists, or, without a
    list, in every cell that reports the metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric["moves"] in reported


def cell(workload: str, root: str = ROOT,
         manifest: Optional[Dict] = None) -> Cell:
    man = manifest if manifest is not None else load_json(
        os.path.join(root, "BENCHMARK.json"))
    by_name = {w["name"]: w for w in man["workloads"]}
    if workload not in by_name:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(there are: {', '.join(sorted(by_name))})")
    w = by_name[workload]
    conf = {c["name"]: c for c in man["configs"]}[w["config"]]
    config = load_json(os.path.join(root, conf["file"]))
    traffic = load_json(os.path.join(HERE, "traffic", f"{w['traffic']}.json"))
    e2e = [m for m in man["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    reported = {m["name"] for m in e2e}
    per = [m for m in man["per_layer"] if _applies(m, workload, reported)]
    return Cell(workload, int(w["chips"]), config, traffic, e2e, per, root)


def check(man: Optional[Dict] = None, root: str = ROOT) -> List[str]:
    """What in the manifest (by default ``root``'s BENCHMARK.json) breaks
    the benchmark's contract on names, units, keys and files (an empty
    list when nothing does)."""
    if man is None:
        man = load_json(os.path.join(root, "BENCHMARK.json"))
    out = []
    if set(man) != TOP_KEYS:
        out.append(f"top-level keys {sorted(man)}")
    names = ([c["name"] for c in man["configs"]]
             + [w["name"] for w in man["workloads"]]
             + [m["name"] for m in man["end_to_end"] + man["per_layer"]])
    for n in names + [w["traffic"] for w in man["workloads"]] + \
            [k for c in man["configs"] for k in c["reduced"]]:
        if not NAME.match(n):
            out.append(f"name {n!r}")
    metric_names = [m["name"] for m in man["end_to_end"] + man["per_layer"]]
    for group in ([c["name"] for c in man["configs"]],
                  [w["name"] for w in man["workloads"]], metric_names):
        if len(set(group)) != len(group):
            out.append(f"repeated names in {group}")
    for m in man["end_to_end"] + man["per_layer"]:
        if not UNIT.match(m["unit"]):
            out.append(f"unit {m['unit']!r} of {m['name']}")
        if m["better"] not in ("lower", "higher"):
            out.append(f"better of {m['name']}")
        if not os.path.isfile(os.path.join(HERE, "metrics",
                                           f"{m['name']}.py")):
            out.append(f"no reader for {m['name']}")
    for m in man["end_to_end"]:
        if m["source"] not in ("host_clock", "device_trace"):
            out.append(f"source of {m['name']}")
        if not 0 < m["bound"] <= 0.25:
            out.append(f"bound of {m['name']}")
    for m in man["per_layer"]:
        if m["moves"] not in {e["name"] for e in man["end_to_end"]}:
            out.append(f"moves of {m['name']}")
        if m["source"] not in ("device_trace", "program_span",
                               "program_counter", "host_clock"):
            out.append(f"source of {m['name']}")
    for c in man["configs"]:
        if not os.path.isfile(os.path.join(root, c["file"])):
            out.append(f"no file {c['file']}")
        else:
            conf = load_json(os.path.join(root, c["file"]))
            if not os.path.isfile(os.path.join(
                    HERE, "references", f"{conf['reference']}.py")):
                out.append(f"no reference for {c['name']}")
    for w in man["workloads"]:
        path = os.path.join(HERE, "traffic", f"{w['traffic']}.json")
        if not os.path.isfile(path):
            out.append(f"no traffic file for {w['name']}")
        else:
            for kind in phantom_kinds(load_json(path)["phantom"]):
                if kind not in BUILT_IN_KINDS and not os.path.isfile(
                        kind_path(kind)):
                    out.append(f"no phantom kind {kind} for {w['name']}")
        if w["chips"] not in (1, 4) or len(w["why"]) > 200:
            out.append(f"chips or why of {w['name']}")
    return out
