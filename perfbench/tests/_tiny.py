"""Tiny cells for the CPU tests: the repository's BENCHMARK.json and
traffic mixes with configurations small enough for the CPU."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
for p in (str(REPO), str(REPO / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY = {
    "lp-dense-3840x7680": {"family": "rand", "shapes": [[24, 48]],
                           "density": None, "seeds": [0, 1, 2, 3],
                           "dtype": "float64",
                           "options": {"tol": 1e-6, "max_iters": 20000,
                                       "check_every": 100}},
    # seeds whose tiny LPs reach tol within the budget
    "lp-sparse-miplib-x128": {"family": "sprand",
                              "shapes": [[32, 64], [48, 96]],
                              "density": 0.15, "seeds": [2, 1, 4, 3],
                              "dtype": "float64",
                              "options": {"tol": 1e-6, "max_iters": 8000,
                                          "check_every": 100}},
}


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
        cfg = dict(cfg, name=name,
                   options={**cfg["options"], **(options or {})})
        (tmp / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    return tmp

