"""FeatInsight core: feature views, unified offline/online computation,
compact time-series storage, signatures, and consistency verification.

The reference package's ``repro.core`` surface.  Its ``make_shard_mesh``
has no counterpart: one GPU holds every shard, the shard axis is a tensor
axis of the state."""

from repro_torch.core.expr import (  # noqa: F401
    Agg,
    Col,
    Expr,
    Hash,
    LastJoin,
    Lit,
    Signature,
    TableCol,
    WindowAgg,
    WindowSpec,
    last_join,
    range_window,
    rows_window,
    w_count,
    w_distinct_approx,
    w_first,
    w_last,
    w_max,
    w_mean,
    w_min,
    w_std,
    w_sum,
    w_topn_freq,
)
from repro_torch.core.aggregates import AGG_SPECS, AggSpec, agg_spec  # noqa: F401
from repro_torch.core.storage import Database, RowCodec, TableSchema  # noqa: F401
from repro_torch.core.layout import (  # noqa: F401
    BucketPlan,
    LaneSlot,
    RingPlan,
    StoreLayout,
    diff_layouts,
    plan_layout,
)
from repro_torch.core.view import FeatureRegistry, FeatureView, render_sql  # noqa: F401
from repro_torch.core.engine import OfflineEngine  # noqa: F401
from repro_torch.core.online import OnlineFeatureStore, QueryProgram  # noqa: F401
from repro_torch.core.migrate import MigrationReport  # noqa: F401
from repro_torch.core.shard import ShardedOnlineStore  # noqa: F401
from repro_torch.core.scenario import ScenarioPlane, merge_views  # noqa: F401
from repro_torch.core.consistency import ConsistencyReport, verify_view  # noqa: F401
