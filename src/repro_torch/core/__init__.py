"""The paper's three strategies (S1 replication, S2 remote writes, S3
locality layout) and the algorithms they apply to, in PyTorch."""
from .bfs import (
    UNVISITED,
    BFSRunStats,
    bfs_bytes_moved,
    bfs_effective_bandwidth,
    bfs_local,
    bfs_traffic,
    teps,
    validate_parents,
)
from .cost import CostEstimate, cost_model_for, register_cost_model
from .gsana import (
    DEFAULT_VOCAB,
    Placement,
    PlanStats,
    compute_similarity,
    gsana_effective_bw,
    gsana_rw_bytes,
    layout_blk,
    layout_hcb,
    plan_stats,
    recall_at_k,
    similarity_block,
)
from .gsana_data import (
    Buckets,
    VertexSet,
    bucketize,
    generate_alignment_pair,
    neighbor_buckets,
    pick_grid,
)
from .spmv import (
    PartitionedELL,
    effective_bandwidth,
    gather_result,
    partition_ell,
    spmv_bytes_moved,
    spmv_local,
    spmv_traffic,
    stripe_vector,
    unstripe_vector,
)
from .strategies import (
    CONTEXT_BYTES,
    WRITE_PACKET_BYTES,
    Comm,
    Layout,
    MigratoryStrategy,
    Scheme,
    TrafficStats,
    strategy_grid,
)
from .util import ceil_div, round_up
