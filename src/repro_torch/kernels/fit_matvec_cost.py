"""Fit B1's and B4's planner cost models to a ``chip_smoke.py`` body survey.

    python -m repro_torch.kernels.fit_matvec_cost chip_smoke.log

reads phase 2's B1 (bf16) and B4 lines, where every body's time sits beside
its K splits, fits each :class:`~repro_torch.kernels.tiled_matvec.CostModel`
term by least relative squares (the CUDA-core body and the tensor-core
bodies apart), and prints the fitted constants, how far the fitted and the
installed models are from the measured times, and how much slower than the
fastest surveyed body the installed planner's pick is. Runs on the host:
the log holds the card's times.
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
from repro_torch.kernels.tiled_xnor import B4_COST, INT8_BODIES, plan_int8

SMS = 132
LINE = re.compile(r"(B1|B4) (\S+)\s+K=\s*(\d+) r=\s*(\d+) m=\s*(\d+) (bfloat16|int8) "
                  r".*bodies: (.*)")
BODY = re.compile(r"(\w+) ([\d.]+)ms \(model [\d.]+, (\d+) splits\)")
KERNELS = {"B1": (MV_BODIES, B1_COST, lambda m, r, w, b: plan_matvec(m, r, w, SMS, body=b)),
           "B4": (INT8_BODIES, B4_COST, lambda m, r, w, b: plan_int8(m, r, w, SMS, body=b))}


def survey(path: str):
    """{kernel: [(shape, m, r, words, body, splits, us)]} from a log."""
    rows = {"B1": [], "B4": []}
    for line in open(path):
        hit = LINE.match(line)
        if hit:
            k, name, kk, r, m = hit.group(1, 2, 3, 4, 5)
            for body, ms, splits in BODY.findall(hit.group(7)):
                rows[k].append((name, int(m), int(r), int(kk) // 32, body, int(splits),
                                float(ms) * 1e3))
    return rows


def features(m, r, words, bf, splits):
    """The CostModel terms of one call: simt (1, m*r*words/active SMs) or
    tensor-core (1, waves*per*groups, waves*per*n-tiles, splits*m*r)."""
    if bf == 2:
        return [1.0, m * r * words / min(SMS, -(-r // 2)) / 1e3]
    per = -(-words // splits)
    waves = -(-(-(-r // bf) * splits) // SMS)
    return [1.0, waves * per * (bf // 16) / 1e3, waves * per * -(-m // 8) / 1e3,
            (splits > 1) * splits * m * r / 1e3]


def main(path: str) -> None:
    for k, rows in survey(path).items():
        bodies, cost, plan_of = KERNELS[k]
        for kind in ("simt", "mma"):
            sub = [x for x in rows if (bodies[x[4]][0] == 0) == (kind == "simt")]
            if not sub:
                continue
            x = np.array([features(s[1], s[2], s[3], bodies[s[4]][1], s[5]) for s in sub])
            y = np.array([s[6] for s in sub])
            coef = np.linalg.lstsq(x / y[:, None], np.ones(len(y)), rcond=None)[0]
            installed = np.array([matvec_cost(plan_of(s[1], s[2], s[3], s[4]), cost, s[1],
                                              s[2], s[3], SMS) for s in sub])
            fit_err, now_err = np.abs(x @ coef - y) / y, np.abs(installed - y) / y
            print(f"{k} {kind}: fitted {np.round(coef, 5).tolist()} | relative error "
                  f"fitted mean {fit_err.mean():.3f} max {fit_err.max():.3f}, installed "
                  f"mean {now_err.mean():.3f} max {now_err.max():.3f}")
        groups = {}
        for s in rows:
            groups.setdefault((s[0], s[1]), []).append(s)
        loss = []
        for g in groups.values():
            pick = min(g, key=lambda s: matvec_cost(plan_of(s[1], s[2], s[3], s[4]), cost,
                                                    s[1], s[2], s[3], SMS))
            loss.append(pick[6] / min(s[6] for s in g))
        print(f"{k} installed planner: its pick is {np.mean(loss):.3f}x the fastest body "
              f"on average, {np.max(loss):.3f}x at worst ({len(loss)} shapes)")


if __name__ == "__main__":
    main(sys.argv[1])
