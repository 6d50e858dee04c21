"""Roofline terms of one step on one card, from the dry run's counter.

The JAX package's ``launch/roofline.py`` on one device, in seconds:

    compute    = FLOPs / the card's peak bf16 rate
    memory     = bytes / the card's HBM rate
    collective = collective bytes / the card's link rate   (0 on one device)

The JAX package reads FLOPs and bytes from XLA's ``cost_analysis()`` and
collective bytes from the partitioned HLO.  Here they come from
``launch.dryrun.Counter``, a dispatch mode that counts each operator the
eager step runs: FLOPs by ``torch.utils.flop_counter``'s formulas (matrix
products only), bytes as each operator's inputs plus outputs, and the
peak as the live storage.  One device runs no collective, so the
collective term is 0 (the distributed port counts its c10d collectives).

``model_flops_for`` keeps the 6·N·tokens (train) / 2·N·tokens (inference)
convention with N the active parameters; MODEL_FLOPS / FLOPs exposes
recomputation and redundant work.
"""

from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass(frozen=True)
class Card:
    """A card's published figures (NVIDIA's data sheet, dense rates without
    sparsity, at the card's full power limit), not measurements."""

    name: str
    peak_flops: float  # bf16 FLOP/s
    hbm_bw: float  # bytes/s
    link_bw: float  # NVLink bytes/s per direction
    memory_bytes: int  # device memory when the card is not at hand


#: keyed by ``torch.cuda.get_device_name()``
CARDS: Dict[str, Card] = {
    "NVIDIA H100 80GB HBM3": Card(
        name="NVIDIA H100 80GB HBM3",  # SXM5, 700 W
        peak_flops=989.4e12,
        hbm_bw=3.35e12,
        link_bw=450e9,
        memory_bytes=80 * 2**30,
    ),
}
H100 = CARDS["NVIDIA H100 80GB HBM3"]


def card(kind: str) -> Card:
    """The row of ``kind``; an unknown card raises (there is no default)."""
    if kind not in CARDS:
        raise KeyError(f"no published figures for card {kind!r}; known: {sorted(CARDS)}")
    return CARDS[kind]


@dataclasses.dataclass
class Roofline:
    flops: float
    bytes_accessed: float
    coll_bytes: float
    coll_counts: Dict[str, int]
    coll_by_kind: Dict[str, int]
    model_flops: float
    arg_bytes: int = 0
    out_bytes: int = 0
    temp_bytes: int = 0
    peak_bytes: int = 0
    card: Card = H100

    @property
    def t_compute(self) -> float:
        return self.flops / self.card.peak_flops

    @property
    def t_memory(self) -> float:
        return self.bytes_accessed / self.card.hbm_bw

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / self.card.link_bw

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops / self.flops if self.flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """useful compute time / bound time — the score we hillclimb."""
        bound = max(self.t_compute, self.t_memory, self.t_collective)
        return (self.model_flops / self.card.peak_flops) / bound if bound else 0.0

    def to_json(self) -> dict:
        return {
            "flops": self.flops,
            "bytes_accessed": self.bytes_accessed,
            "coll_bytes": self.coll_bytes,
            "coll_counts": self.coll_counts,
            "coll_by_kind": self.coll_by_kind,
            "model_flops": self.model_flops,
            "t_compute": self.t_compute,
            "t_memory": self.t_memory,
            "t_collective": self.t_collective,
            "bottleneck": self.bottleneck,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "arg_bytes": self.arg_bytes,
            "out_bytes": self.out_bytes,
            "temp_bytes": self.temp_bytes,
            "peak_bytes": self.peak_bytes,
            "device_kind": self.card.name,
        }


def measure(counter) -> dict:
    """The counted step's FLOPs and bytes, in ``extrapolate``'s keys (no
    collectives on one device)."""
    return {
        "flops": float(counter.flops),
        "bytes_accessed": float(counter.bytes),
        "coll_bytes": 0.0,
        "coll_counts": {},
        "coll_by_kind": {},
    }


def extrapolate(m1: dict, m2: dict, units: float) -> dict:
    """Linear depth extrapolation: cost(U) = m1 + (U-1)·(m2-m1), from the
    counts of 1-unit and 2-unit models (the stack is homogeneous by
    construction)."""
    out = {}
    for key in ("flops", "bytes_accessed", "coll_bytes"):
        per = m2[key] - m1[key]
        out[key] = m1[key] + (units - 1.0) * per
    out["coll_counts"] = {
        k: int(round(m1["coll_counts"].get(k, 0) + (units - 1.0) * (m2["coll_counts"].get(k, 0) - m1["coll_counts"].get(k, 0))))
        for k in set(m1["coll_counts"]) | set(m2["coll_counts"])
    }
    out["coll_by_kind"] = {
        k: int(round(m1["coll_by_kind"].get(k, 0) + (units - 1.0) * (m2["coll_by_kind"].get(k, 0) - m1["coll_by_kind"].get(k, 0))))
        for k in set(m1["coll_by_kind"]) | set(m2["coll_by_kind"])
    }
    return out


def memory_stats(counter) -> dict:
    """The step's inputs (``arg``), the outputs it allocated (``out``), the
    peak of live storage with the inputs, and ``temp`` = peak - arg - out."""
    return {
        "arg_bytes": counter.arg_bytes,
        "out_bytes": counter.out_bytes,
        "temp_bytes": counter.peak - counter.arg_bytes - counter.out_bytes,
        "peak_bytes": counter.peak,
    }


def roofline_from(meas: dict, model_flops: float, mem: dict, card: Card = H100) -> Roofline:
    return Roofline(
        flops=meas["flops"],
        bytes_accessed=meas["bytes_accessed"],
        coll_bytes=meas["coll_bytes"],
        coll_counts=meas["coll_counts"],
        coll_by_kind=meas["coll_by_kind"],
        model_flops=model_flops,
        card=card,
        **mem,
    )


def model_flops_for(cfg, shape, n_devices: int) -> float:
    """Per-device useful FLOPs per step (6ND train / 2ND inference)."""
    n_active = cfg.active_params()
    if shape.kind == "train":
        total = 6 * n_active * shape.tokens
    elif shape.kind == "prefill":
        total = 2 * n_active * shape.tokens
    else:  # decode: one token per sequence
        total = 2 * n_active * shape.global_batch
    return total / n_devices


def analyze(counter, cfg, shape, n_devices: int = 1, card: Card = H100) -> Roofline:
    return roofline_from(measure(counter), model_flops_for(cfg, shape, n_devices), memory_stats(counter), card)
