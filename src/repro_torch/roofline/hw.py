"""NVIDIA H100 peaks, picked by the name ``nvidia-smi`` reports.

Data-sheet figures (dense, no sparsity), for the SXM card at its 700 W
limit and the PCIe and NVL cards at theirs; a card set below its limit
runs slower under load. Rates are per card: HBM bytes/s, bf16 and int8
tensor-core op/s, and f32 and f64 op/s outside the tensor cores.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Card:
    """One H100 variant's data-sheet peaks (per card)."""

    name: str
    hbm_bw: float          # HBM bytes/s
    bf16: float            # bf16 tensor-core flop/s
    f32: float             # f32 flop/s outside the tensor cores
    int8: float            # int8 tensor-core op/s
    f64: float             # f64 flop/s outside the tensor cores

    def peak(self, kind: str) -> float:
        """The op rate of ``kind``: "bf16", "f32", "f64" or "int8"."""
        return {"bf16": self.bf16, "f32": self.f32, "f64": self.f64,
                "int8": self.int8}[kind]


CARDS = {
    "SXM": Card("H100 SXM", 3.35e12, 989e12, 67e12, 1979e12, 34e12),
    "PCIe": Card("H100 PCIe", 2.0e12, 756e12, 51e12, 1513e12, 26e12),
    "NVL": Card("H100 NVL", 3.9e12, 835e12, 60e12, 1671e12, 30e12),
}


def card(name: str = "") -> Card:
    """The peaks of the card ``name`` (as ``nvidia-smi --query-gpu=name``
    gives it): PCIe or NVL by that word, else SXM."""
    for key in ("PCIe", "NVL"):
        if key in name:
            return CARDS[key]
    return CARDS["SXM"]


SXM = CARDS["SXM"]
PEAK_FLOPS_BF16 = SXM.bf16     # flop/s per card
PEAK_OPS_INT8 = SXM.int8       # int8 op/s per card; an xnor word op is
# charged at this rate after the 32-bits-per-word conversion of
# roofline.analysis.integer_dense_ops
HBM_BW = SXM.hbm_bw            # bytes/s per card
HBM_BYTES = 80e9               # bytes per card (H100 80GB)
# The rate behind the collective term, bytes/s per card: one 400 Gb/s
# ConnectX-7 port per card between nodes (DGX H100). NVLink 4 joins the 8
# cards of a node at 900 GB/s a card, but every axis of the production
# mesh spans nodes (launch.mesh.make_production_mesh), so its collectives
# run at the rate between nodes.
LINK_BW = 50e9
