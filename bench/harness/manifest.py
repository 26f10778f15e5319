"""BENCHMARK.json and the files it names.

The harness finds every part of a cell by name: the configuration's file
(``configs[].file``), the traffic mix ``bench/traffic/<traffic>.json``, the
cell's check ``bench/checks/<cell>.json``, the family adapter
``bench/families/<family>.py`` that the configuration's ``family`` names,
the traffic kind ``bench/kinds/<kind>.py`` that the mix's ``kind`` names
(its generator and its loop), and one reader ``bench/metrics/<metric>.py``
per metric. A later change adds a configuration, a mix, a kind of traffic
or a metric as new files and new entries, and edits none of these.
"""
from __future__ import annotations

import importlib
import json
import re
from pathlib import Path
from typing import Dict, List, Optional

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES_E2E = ("host_clock", "device_trace")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


class ManifestError(ValueError):
    pass


def load(path: Optional[Path] = None) -> dict:
    with open(path or ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def workload(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise ManifestError(f"no workload {name!r} in BENCHMARK.json "
                        f"(have {[w['name'] for w in manifest['workloads']]})")


def config_entry(manifest: dict, name: str) -> dict:
    for c in manifest["configs"]:
        if c["name"] == name:
            return c
    raise ManifestError(f"no configuration {name!r} in BENCHMARK.json")


def load_config(manifest: dict, name: str) -> dict:
    with open(ROOT / config_entry(manifest, name)["file"]) as f:
        return json.load(f)


def traffic_path(name: str) -> Path:
    return BENCH / "traffic" / f"{name}.json"


def load_traffic(name: str) -> dict:
    with open(traffic_path(name)) as f:
        return json.load(f)


def check_path(cell: str) -> Path:
    return BENCH / "checks" / f"{cell}.json"


def load_check(cell: str) -> dict:
    """The cell's check: what it samples and the limit of each number
    compared, with the readings each limit was set from."""
    with open(check_path(cell)) as f:
        return json.load(f)


def family(config: dict):
    """The adapter module of the configuration's family."""
    return importlib.import_module(f"bench.families.{config['family']}")


def kind(mix: dict):
    """The module of the mix's traffic kind: its generator and its loop."""
    return importlib.import_module(f"bench.kinds.{mix['kind']}")


def metric_module(name: str):
    return importlib.import_module(f"bench.metrics.{name}")


def metrics_for(manifest: dict, cell: str, kind: str) -> List[dict]:
    """The ``end_to_end`` or ``per_layer`` entries that ``cell`` reports:
    those that list it under ``workloads``, or that have no such key."""
    return [m for m in manifest[kind] if cell in m.get("workloads", [cell])]


def validate(manifest: dict) -> List[str]:
    """What is wrong with the manifest by the benchmark's rules (an empty
    list when nothing is): names, units, files found by name, and each
    per-layer metric's ``moves`` reported in the cells it lists."""
    bad = []
    need = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    if set(manifest) != need:
        bad.append(f"top-level keys {sorted(manifest)} != {sorted(need)}")
    names = ([c["name"] for c in manifest["configs"]] + [w["name"] for w in manifest["workloads"]]
             + [m["name"] for m in manifest["end_to_end"] + manifest["per_layer"]])
    names += [w["traffic"] for w in manifest["workloads"]] + [w["config"] for w in manifest["workloads"]]
    names += [k for c in manifest["configs"] for k in c["reduced"]]
    bad += [f"bad name {n!r}" for n in names if not NAME.match(n)]
    for group in ("configs", "workloads"):
        seen = [x["name"] for x in manifest[group]]
        bad += [f"duplicate {group} name {n!r}" for n in set(seen) if seen.count(n) > 1]
    metric_names = [m["name"] for m in manifest["end_to_end"] + manifest["per_layer"]]
    bad += [f"duplicate metric {n!r}" for n in set(metric_names) if metric_names.count(n) > 1]
    cells = {w["name"]: w for w in manifest["workloads"]}
    pairs = [(w["config"], w["traffic"]) for w in manifest["workloads"]]
    bad += [f"pair {p} twice" for p in set(pairs) if pairs.count(p) > 1]

    for c in manifest["configs"]:
        if set(c) != {"name", "source", "file", "reduced", "why"}:
            bad.append(f"config {c['name']}: keys {sorted(c)}")
        if not (ROOT / c["file"]).is_file():
            bad.append(f"config {c['name']}: no file {c['file']}")
            continue
        fam = json.loads((ROOT / c["file"]).read_text()).get("family")
        if not (BENCH / "families" / f"{fam}.py").is_file():
            bad.append(f"config {c['name']}: no adapter bench/families/{fam}.py")
        if not any(w["config"] == c["name"] for w in manifest["workloads"]):
            bad.append(f"config {c['name']}: no cell uses it")
    for w in manifest["workloads"]:
        if set(w) != {"name", "config", "traffic", "chips", "why"}:
            bad.append(f"workload {w['name']}: keys {sorted(w)}")
        if w["chips"] not in (1, 4):
            bad.append(f"workload {w['name']}: chips {w['chips']}")
        if not traffic_path(w["traffic"]).is_file():
            bad.append(f"workload {w['name']}: no traffic file {traffic_path(w['traffic'])}")
        elif not (BENCH / "kinds" / f"{load_traffic(w['traffic']).get('kind')}.py").is_file():
            bad.append(f"workload {w['name']}: no traffic kind bench/kinds/<kind>.py for its mix")
        if not check_path(w["name"]).is_file():
            bad.append(f"workload {w['name']}: no check file {check_path(w['name'])}")
        if not any(c["name"] == w["config"] for c in manifest["configs"]):
            bad.append(f"workload {w['name']}: no configuration {w['config']}")
    for kind in ("end_to_end", "per_layer"):
        for m in manifest[kind]:
            keys = {"name", "unit", "better", "source"}
            keys |= {"bound"} if kind == "end_to_end" else {"layer", "moves"}
            if set(m) - {"workloads"} != keys:
                bad.append(f"metric {m['name']}: keys {sorted(m)}")
            if not UNIT.match(m["unit"]):
                bad.append(f"metric {m['name']}: bad unit {m['unit']!r}")
            if m["better"] not in ("lower", "higher"):
                bad.append(f"metric {m['name']}: better {m['better']!r}")
            if m["source"] not in (SOURCES_E2E if kind == "end_to_end" else SOURCES):
                bad.append(f"metric {m['name']}: source {m['source']!r}")
            if not (BENCH / "metrics" / f"{m['name']}.py").is_file():
                bad.append(f"metric {m['name']}: no reader bench/metrics/{m['name']}.py")
            bad += [f"metric {m['name']}: unknown cell {c}" for c in m.get("workloads", [])
                    if c not in cells]
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    if "setup_s" not in e2e:
        bad.append("no setup_s")
    for m in manifest["per_layer"]:
        moved = e2e.get(m["moves"])
        if moved is None:
            bad.append(f"metric {m['name']}: moves {m['moves']!r}, not an end-to-end metric")
            continue
        for c in m.get("workloads", list(cells)):
            if c not in moved.get("workloads", cells):
                bad.append(f"metric {m['name']}: cell {c} does not report {m['moves']}")
    for c in cells:
        e = [m["name"] for m in metrics_for(manifest, c, "end_to_end")]
        if "setup_s" not in e or len(e) < 2:
            bad.append(f"cell {c}: end-to-end metrics {e}")
        if not metrics_for(manifest, c, "per_layer"):
            bad.append(f"cell {c}: no per-layer metric")
    return bad


def seconds_budget(manifest: dict, cells: int = 24) -> Dict[str, float]:
    """The full check's time at ``cells`` cells: 2 + 14 cells runs of
    ``run_seconds`` + 60 s, 2 x 90 s a cell to compile, 1,200 s spare."""
    runs = 2 + 14 * cells
    total = runs * (manifest["run_seconds"] + 60) + cells * 180 + 1200
    return {"runs": runs, "seconds": total, "limit": 43200}
