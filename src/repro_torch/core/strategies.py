"""The paper's three programming strategies as a first-class config.

S1 ``replicate_x``  — replicate read-hot dense operands (paper §5.1)
S2 ``comm``         — ``migrate`` (pull/gather, Alg. 1) vs ``remote_write``
                      (push/scatter with commutative merge, Alg. 2)
S3 ``layout``       — ``blk`` (ID-blocked) vs ``hcb`` (Hilbert-curve bucket)
                      placement (paper §3.3.2)
``grain``           — rows/work-items per task; ``None`` = dynamic grain
                      (paper Fig. 4's lesson)

The enum values and :meth:`MigratoryStrategy.cache_key` are the same as the
JAX package's, so plan keys and report rows name strategies identically.
"""
from __future__ import annotations

import dataclasses
import enum


class Comm(str, enum.Enum):
    MIGRATE = "migrate"  # pull: move the reader to the data (Emu) / gather
    REMOTE_WRITE = "remote_write"  # push: one-sided writes + local commit phase


class Layout(str, enum.Enum):
    BLK = "blk"  # block/striped by id, placement-oblivious
    HCB = "hcb"  # Hilbert-curve-based locality + load-balanced placement


class Scheme(str, enum.Enum):
    """GSANA task granularity (paper §3.3.1)."""

    ALL = "all"  # one task per bucket (coarse, imbalance-prone)
    PAIR = "pair"  # one task per bucket pair (fine, balanced)


@dataclasses.dataclass(frozen=True)
class MigratoryStrategy:
    comm: Comm = Comm.REMOTE_WRITE
    replicate_x: bool = True
    layout: Layout = Layout.HCB
    scheme: Scheme = Scheme.PAIR
    grain: int | None = None  # None => dynamic grain

    def dynamic_grain(self, n_rows: int, target_tasks: int = 512) -> int:
        """Paper Fig. 4: fixed grain 16 does not scale; pick grain so the
        task count saturates (but does not swamp) the machine."""
        if self.grain is not None:
            return self.grain
        return max(1, n_rows // target_tasks)

    def cache_key(self) -> tuple:
        """Hashable identity of the strategy — part of the plan-cache key
        (engine/cache.py): two runs share an executor only if every
        strategy axis matches."""
        return (self.comm.value, self.replicate_x, self.layout.value,
                self.scheme.value, self.grain)



def strategy_grid(
    comms: tuple[Comm, ...] = (Comm.MIGRATE, Comm.REMOTE_WRITE),
    replicates: tuple[bool, ...] = (True, False),
    layouts: tuple[Layout, ...] = (Layout.BLK, Layout.HCB),
    schemes: tuple[Scheme, ...] = (Scheme.ALL, Scheme.PAIR),
    grains: tuple[int | None, ...] = (None,),
) -> list[MigratoryStrategy]:
    """The full S1 x S2 x S3 x grain candidate cross product, in a
    deterministic order (the autotuner's search space)."""
    return [
        MigratoryStrategy(comm=c, replicate_x=r, layout=l, scheme=s, grain=g)
        for c in comms for r in replicates for l in layouts for s in schemes
        for g in grains
    ]

# -- traffic model ------------------------------------------------------------
# The Emu cost model used to report the paper's metrics on non-Emu hardware:
# a migration moves a thread context (<200 B, §2); a remote write is a small
# packet (§5.2 "smaller size of remote write packets").
CONTEXT_BYTES = 200
WRITE_PACKET_BYTES = 16


@dataclasses.dataclass
class TrafficStats:
    """Modeled communication traffic (the paper's migration-count lens)."""

    migrations: int = 0
    remote_writes: int = 0
    collective_bytes: int = 0  # bytes moved by collectives

    @property
    def migration_bytes(self) -> int:
        return self.migrations * CONTEXT_BYTES

    @property
    def remote_write_bytes(self) -> int:
        return self.remote_writes * WRITE_PACKET_BYTES

    @property
    def total_bytes(self) -> int:
        return self.migration_bytes + self.remote_write_bytes + self.collective_bytes

    def __add__(self, o: "TrafficStats") -> "TrafficStats":
        return TrafficStats(
            self.migrations + o.migrations,
            self.remote_writes + o.remote_writes,
            self.collective_bytes + o.collective_bytes,
        )
