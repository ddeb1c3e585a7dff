"""Fit B1's, B3's and B4's planner cost models to a ``chip_smoke.py`` body
survey.

    python -m repro_torch.kernels.fit_matvec_cost chip_smoke.log

reads phase 2's B1 (bf16), B3 and B4 lines, where every body's time sits
beside its K splits, fits each :class:`~repro_torch.kernels.tiled_matvec.CostModel`
term by least relative squares (the CUDA-core body and the tensor-core
bodies apart), and prints the fitted constants, how far the fitted and the
installed models are from the measured times, and how much slower than the
fastest surveyed body the installed planner's pick is. B3's surveyed
names carry the split reduction ("bmma32/cluster"); its CUDA-core body is
fitted where the planner offers it (m <= XNOR_POPC_MAX_M). Runs on the
host: the log holds the card's times.
"""
from __future__ import annotations

import re
import sys

import numpy as np

from repro_torch.kernels.tiled_matvec import (
    B1_COST,
    MV_BODIES,
    matvec_cost,
    plan_matvec,
)
from repro_torch.kernels.tiled_xnor import (
    B3_COST,
    B4_COST,
    INT8_BODIES,
    XNOR_BODIES,
    XNOR_POPC_MAX_M,
    plan_int8,
    plan_xnor,
)

SMS = 132
LINE = re.compile(r"(B1|B3|B4) (\S+)\s+K=\s*(\d+) r=\s*(\d+) m=\s*(\d+) "
                  r"(bfloat16|int8|xnor) .*bodies: (.*)")
BODY = re.compile(r"([\w/]+) ([\d.]+)ms \(model [\d.]+, (\d+) splits\)")


def _xnor_plan(m, r, w, name):
    body, _, reduce = (name or "").partition("/")
    return plan_xnor(m, r, w, SMS, body or None, reduce or None)


# kernel -> (bodies, installed cost model, plan of a surveyed name)
KERNELS = {"B1": (MV_BODIES, B1_COST, lambda m, r, w, b: plan_matvec(m, r, w, SMS, body=b)),
           "B3": (XNOR_BODIES, B3_COST, _xnor_plan),
           "B4": (INT8_BODIES, B4_COST, lambda m, r, w, b: plan_int8(m, r, w, SMS, body=b))}


def survey(path: str):
    """{kernel: [(shape, m, r, words, body, splits, us)]} from a log."""
    rows = {k: [] for k in KERNELS}
    for line in open(path):
        hit = LINE.match(line)
        if hit:
            k, name, kk, r, m = hit.group(1, 2, 3, 4, 5)
            for body, ms, splits in BODY.findall(hit.group(7)):
                rows[k].append((name, int(m), int(r), int(kk) // 32, body, int(splits),
                                float(ms) * 1e3))
    return rows


def features(plan, m, r, words):
    """The CostModel terms of one call: simt (1, m*r*words/active SMs, and
    for B3 m*waves) or tensor-core (1, waves*per*groups, waves*per*n-tiles,
    then the split terms: splits*m*r for B1 / B4's split pass; for B3 the
    cluster's (1, n-tiles))."""
    waves = -(-plan.blocks(r) // SMS)
    if plan.code == 0:
        f = [1.0, m * r * words / min(SMS, plan.blocks(r)) / 1e3]
        return f + [m * waves / 1e3] if plan.body == "popc" else f
    f = [1.0, waves * plan.per_split * (plan.bf // 16) / 1e3,
         waves * plan.per_split * -(-m // 8) / 1e3]
    if plan.body.startswith("bmma"):
        return f + [float(plan.cluster), plan.cluster * -(-m // 8)]
    return f + [(plan.splits > 1) * plan.splits * m * r / 1e3]


def main(path: str) -> None:
    for k, rows in survey(path).items():
        if not rows:
            continue
        bodies, cost, plan_of = KERNELS[k]
        plans = [plan_of(s[1], s[2], s[3], s[4]) for s in rows]
        for kind in ("simt", "mma"):
            sub = [(s, p) for s, p in zip(rows, plans) if (p.code == 0) == (kind == "simt")
                   and not (p.body == "popc" and s[1] > XNOR_POPC_MAX_M)]
            if not sub:
                continue
            x = np.array([features(p, s[1], s[2], s[3]) for s, p in sub])
            y = np.array([s[6] for s, _ in sub])
            coef = np.linalg.lstsq(x / y[:, None], np.ones(len(y)), rcond=None)[0]
            installed = np.array([matvec_cost(p, cost, s[1], s[2], s[3], SMS)
                                  for s, p in sub])
            fit_err, now_err = np.abs(x @ coef - y) / y, np.abs(installed - y) / y
            print(f"{k} {kind}: fitted {np.round(coef, 5).tolist()} | relative error "
                  f"fitted mean {fit_err.mean():.3f} max {fit_err.max():.3f}, installed "
                  f"mean {now_err.mean():.3f} max {now_err.max():.3f}")
        groups = {}
        for s, p in zip(rows, plans):
            groups.setdefault((s[0], s[1]), []).append((s, p))
        loss = []
        for (_, m), g in groups.items():
            r, words = g[0][0][2], g[0][0][3]
            pick = plan_of(m, r, words, None)
            picked = [s[6] for s, p in g if p == pick]
            if picked:
                loss.append(picked[0] / min(s[6] for s, _ in g))
        print(f"{k} installed planner: its pick is {np.mean(loss):.3f}x the fastest body "
              f"on average, {np.max(loss):.3f}x at worst ({len(loss)} shapes)")


if __name__ == "__main__":
    main(sys.argv[1])
