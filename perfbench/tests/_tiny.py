"""Tiny cells for the CPU tests: the repository's BENCHMARK.json and
traffic mixes with configurations small enough for the CPU.

Each configuration's tiny sizes are a file of their own,
``tiny/<config>.json``, laid over the configuration's own file: what a
tiny file gives replaces the configuration's key of that name, and what
it leaves out (a crossbar's device block, say) is the configuration's."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
for p in (str(REPO), str(REPO / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_DIR = Path(__file__).resolve().parent / "tiny"
TINY = {p.stem: json.loads(p.read_text())
        for p in sorted(TINY_DIR.glob("*.json"))}


def bench() -> dict:
    with open(REPO / "BENCHMARK.json") as f:
        return json.load(f)


def tiny_data(tmp: Path, options=None) -> Path:
    """configs/ (tiny), traffic/ and checks/ (the repository's) under
    ``tmp``; ``options`` updates every tiny configuration's options."""
    src = REPO / "perfbench"
    for sub in ("traffic", "checks"):
        shutil.copytree(src / sub, tmp / sub)
    (tmp / "configs").mkdir()
    for name, cfg in TINY.items():
        full = json.loads((src / "configs" / f"{name}.json").read_text())
        cfg = {**full, **cfg, "name": name,
               "options": {**cfg["options"], **(options or {})}}
        (tmp / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    return tmp
