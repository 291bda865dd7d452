"""Finds a cell's pieces by the names in ``BENCHMARK.json``.

- a configuration: ``bench_h100/configs/<name>.json``;
- a traffic mix: ``bench_h100/traffic/<name>.json``, whose ``kind`` names
  the job (``bench_h100/jobs/<kind>.py``);
- a metric, end-to-end or per-layer: ``bench_h100/metrics/<name>.py``,
  whose ``read(m)`` takes the run's ``window.Measurement`` and returns a
  number, or None where it finds nothing to read.

A later change adds a configuration, a mix or a metric as new files and
entries, without editing one that is there.
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Callable, Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(HERE)
PACKAGE = os.path.basename(HERE)


def load_reader(folder: str, name: str) -> Callable:
    """``read`` of ``<folder>/<name>.py``: a metric's reader, which may
    take another's as its own."""
    spec = importlib.util.spec_from_file_location(
        f"{PACKAGE}_metric_{name.replace('.', '_')}",
        os.path.join(folder, name + ".py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


class Registry:
    """The benchmark under ``root`` (a checkout: ``BENCHMARK.json`` and
    ``bench_h100/``)."""

    def __init__(self, root: str = CHECKOUT):
        self.root = root
        with open(os.path.join(root, "BENCHMARK.json")) as fh:
            self.spec = json.load(fh)
        self.dir = os.path.join(root, PACKAGE)

    def cell(self, name: str) -> Dict:
        for cell in self.spec["workloads"]:
            if cell["name"] == name:
                return cell
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def _json(self, folder: str, name: str) -> Dict:
        with open(os.path.join(self.dir, folder, name + ".json")) as fh:
            return json.load(fh)

    def config(self, name: str) -> Dict:
        return self._json("configs", name)

    def traffic(self, name: str) -> Dict:
        return self._json("traffic", name)

    def reader(self, name: str) -> Callable:
        """``read`` of ``metrics/<name>.py`` (names may hold dots)."""
        return load_reader(os.path.join(self.dir, "metrics"), name)

    def metrics(self, cell: str, per_layer: bool) -> List[Dict]:
        """The metrics a cell reports: its end-to-end ones (those that
        list no cells are every cell's), or the per-layer ones that list
        it (every per-layer metric lists its cells)."""
        if per_layer:
            return [x for x in self.spec["per_layer"]
                    if cell in x["workloads"]]
        return [x for x in self.spec["end_to_end"]
                if cell in x.get("workloads", [cell])]
