"""Collective traffic of a run: bytes on the wire by kind, from what the ranks issued.

The counterpart of ``repro.launch.hlo_analysis`` for the port. The
reference parses the compiled HLO's collectives; the port runs eagerly and
has no HLO to parse, so its record is the list that
``core.collectives.timed()`` keeps of every collective a rank issues
within the block (kind, result bytes, group size: the port's own
collectives, ``core.repartition``'s all-to-all and the trainer's gradient
all-reduce). Each call is costed by the reference's ring-algorithm model
(``wire_bytes``, a copy of ``hlo_analysis._wire_bytes``) into the bytes a
rank puts on the wire; ``CollectiveStats`` sums them by kind and keeps the
largest sites (here a site is a (kind, result bytes, group size) shape of
call, and its bytes those of all its calls).
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, Iterable, Tuple


def wire_bytes(kind: str, result_bytes: int, g: int) -> float:
    """Per-rank bytes on the wire of one collective (ring-algorithm model)."""
    if g <= 1:
        return 0.0
    frac = (g - 1) / g
    if kind == "all-gather":
        return result_bytes * frac          # receives (g-1)/g of the output
    if kind == "all-reduce":
        return 2.0 * result_bytes * frac    # reduce-scatter + all-gather
    if kind == "reduce-scatter":
        return result_bytes * (g - 1)       # result is the scattered shard
    if kind == "all-to-all":
        return result_bytes * frac          # sends (g-1)/g of its tile
    if kind == "collective-permute":
        return float(result_bytes)
    return 0.0


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_kind: Dict[str, float]
    count_by_kind: Dict[str, int]
    bytes_by_site: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def total_bytes(self) -> float:
        return sum(self.bytes_by_kind.values())

    def top_sites(self, n: int = 10):
        return sorted(self.bytes_by_site.items(), key=lambda kv: -kv[1])[:n]

    def to_dict(self) -> dict:
        return {"bytes_by_kind": dict(self.bytes_by_kind),
                "count_by_kind": dict(self.count_by_kind),
                "total_bytes": self.total_bytes, "top_sites": self.top_sites(8)}


def collective_stats(ops: Iterable[Tuple[str, int, int]]) -> CollectiveStats:
    """``CollectiveStats`` of a ``timed()`` record's ``ops``."""
    by_kind, count, by_site = defaultdict(float), defaultdict(int), defaultdict(float)
    for kind, nbytes, g in ops:
        w = wire_bytes(kind, nbytes, g)
        by_kind[kind] += w
        count[kind] += 1
        by_site[f"{kind} of {nbytes} B over {g}"] += w
    return CollectiveStats(dict(by_kind), dict(count), dict(by_site))


def wire_line(ops) -> str:
    """The wire bytes by kind of a ``timed()`` record, in words."""
    st = collective_stats(ops)
    kinds = ", ".join(f"{k} {v / 2**20:.2f} MiB ({st.count_by_kind[k]} calls)"
                      for k, v in sorted(st.bytes_by_kind.items()))
    return f"wire {st.total_bytes / 2**20:.2f} MiB a rank ({kinds or 'none'})"
