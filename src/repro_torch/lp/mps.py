"""Minimal fixed/free-format MPS reader + writer.

The paper benchmarks MIPLIB-2017 instances distributed as .mps files; the
container is offline so generated instances stand in (generators.py), but
this reader lets the same pipeline consume the real files when present:

    lp = mps.read("gen-ip002.mps").to_standard()
    core.solve_jit(lp, ...)

Supported sections: NAME, ROWS (N/L/G/E), COLUMNS (incl. integer
markers — integrality is relaxed, matching the paper's use of LP
relaxations), RHS, RANGES, BOUNDS (UP/LO/FX/FR/BV/MI/PL).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from .problem import INF, LPProblem


def read(path: str) -> LPProblem:
    with open(path) as f:
        return parse(f.read(), name=path)


def parse(text: str, name: str = "mps") -> LPProblem:
    section = None
    obj_row = None
    row_sense: Dict[str, str] = {}
    row_order: List[str] = []
    cols: Dict[str, Dict[str, float]] = {}
    col_order: List[str] = []
    rhs: Dict[str, float] = {}
    ranges: Dict[str, float] = {}
    lbs: Dict[str, float] = {}
    ubs: Dict[str, float] = {}
    integer_mode = False

    for raw in text.splitlines():
        if not raw.strip() or raw.lstrip().startswith("*"):
            continue
        if raw[0] not in " \t":
            head = raw.split()
            section = head[0].upper()
            continue
        tok = raw.split()
        if section == "ROWS":
            sense, rname = tok[0].upper(), tok[1]
            if sense == "N":
                if obj_row is None:
                    obj_row = rname
            else:
                row_sense[rname] = sense
                row_order.append(rname)
        elif section == "COLUMNS":
            if len(tok) >= 3 and tok[1].upper() == "'MARKER'":
                integer_mode = tok[2].upper() == "'INTORG'"
                continue
            cname = tok[0]
            if cname not in cols:
                cols[cname] = {}
                col_order.append(cname)
                if integer_mode:
                    # LP relaxation: integer columns default to [0, 1]
                    # only if BOUNDS later says BV; else [0, +inf)
                    pass
            for rname, val in zip(tok[1::2], tok[2::2]):
                cols[cname][rname] = float(val)
        elif section == "RHS":
            for rname, val in zip(tok[1::2], tok[2::2]):
                rhs[rname] = float(val)
        elif section == "RANGES":
            for rname, val in zip(tok[1::2], tok[2::2]):
                ranges[rname] = float(val)
        elif section == "BOUNDS":
            btype, cname = tok[0].upper(), tok[2]
            val = float(tok[3]) if len(tok) > 3 else 0.0
            if btype == "UP":
                ubs[cname] = val
            elif btype == "LO":
                lbs[cname] = val
            elif btype == "FX":
                lbs[cname] = val
                ubs[cname] = val
            elif btype == "FR":
                lbs[cname] = -INF
            elif btype == "MI":
                lbs[cname] = -INF
            elif btype == "BV":
                lbs[cname] = 0.0
                ubs[cname] = 1.0
            elif btype == "PL":
                ubs[cname] = INF

    n = len(col_order)
    cidx = {c: j for j, c in enumerate(col_order)}
    c_vec = np.zeros(n)
    G_rows, h_vals, A_rows, b_vals = [], [], [], []
    for rname in row_order:
        sense = row_sense[rname]
        row = np.zeros(n)
        for cname, vals in cols.items():
            if rname in vals:
                row[cidx[cname]] = vals[rname]
        b = rhs.get(rname, 0.0)
        rng = ranges.get(rname)
        if sense == "G":
            G_rows.append(row)
            h_vals.append(b)
            if rng is not None:
                G_rows.append(-row)
                h_vals.append(-(b + abs(rng)))
        elif sense == "L":
            G_rows.append(-row)
            h_vals.append(-b)
            if rng is not None:
                G_rows.append(row)
                h_vals.append(b - abs(rng))
        else:  # E
            if rng is not None:
                lo, hi = min(b, b + rng), max(b, b + rng)
                G_rows.append(row)
                h_vals.append(lo)
                G_rows.append(-row)
                h_vals.append(-hi)
            else:
                A_rows.append(row)
                b_vals.append(b)
    for cname, vals in cols.items():
        if obj_row in vals:
            c_vec[cidx[cname]] = vals[obj_row]
    lb = np.array([lbs.get(c, 0.0) for c in col_order])
    ub = np.array([ubs.get(c, INF) for c in col_order])
    return LPProblem(
        c=c_vec,
        G=np.array(G_rows) if G_rows else None,
        h=np.array(h_vals) if G_rows else None,
        A=np.array(A_rows) if A_rows else None,
        b=np.array(b_vals) if A_rows else None,
        lb=lb, ub=ub, name=name,
    )


def write(lp: LPProblem, path: str, name: str = "REPRO"):
    """Write the general-form LP as free-format MPS (roundtrip support)."""
    lines = [f"NAME          {name}", "ROWS", " N  OBJ"]
    for i in range(lp.m1):
        lines.append(f" G  R{i}")
    for i in range(lp.m2):
        lines.append(f" E  E{i}")
    lines.append("COLUMNS")
    for j in range(lp.n):
        col = f"X{j}"
        if lp.c[j] != 0.0:
            lines.append(f"    {col}  OBJ  {lp.c[j]:.17g}")
        for i in range(lp.m1):
            if lp.G[i, j] != 0.0:
                lines.append(f"    {col}  R{i}  {lp.G[i, j]:.17g}")
        for i in range(lp.m2):
            if lp.A[i, j] != 0.0:
                lines.append(f"    {col}  E{i}  {lp.A[i, j]:.17g}")
    lines.append("RHS")
    for i in range(lp.m1):
        if lp.h[i] != 0.0:
            lines.append(f"    RHS  R{i}  {lp.h[i]:.17g}")
    for i in range(lp.m2):
        if lp.b[i] != 0.0:
            lines.append(f"    RHS  E{i}  {lp.b[i]:.17g}")
    lines.append("BOUNDS")
    for j in range(lp.n):
        if not np.isfinite(lp.lb[j]):
            lines.append(f" MI BND  X{j}")
        elif lp.lb[j] != 0.0:
            lines.append(f" LO BND  X{j}  {lp.lb[j]:.17g}")
        if np.isfinite(lp.ub[j]):
            lines.append(f" UP BND  X{j}  {lp.ub[j]:.17g}")
    lines.append("ENDATA")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path
