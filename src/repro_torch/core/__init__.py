"""EdgeApproxGeo core in PyTorch: the paper's query engine on one CUDA device.

Layers (bottom-up):
  geohash     — Morton-coded geohash encode/decode (int32 tensor ops)
  stratify    — stratum tables (regular geohash grid + neighborhood map)
  sampling    — EdgeSOS stratified sampling (Algorithm 1) from one uniform
                vector per window
  estimators  — mergeable per-stratum accumulators (moments, extrema,
                quantile sketch) and the stratified estimators (eqs 1-10)
  bounds      — min/max intervals and the stratified bootstrap behind
                var / quantile intervals
  feedback    — the QoS controller adapting sampling fractions to SLOs
                (scalar and vectorized over a tenant population)
  windows     — count/time tumbling windows with named value columns, and
                pane-based ``WindowSpec`` (tumbling/sliding/hopping) shapes
  query       — ``Query``/``AggSpec`` specs lowered to plans, plan fusion,
                and finalize
  codec       — uplink wire codecs (sparse, top-k, quantize, delta) for the
                preagg states, with measured wire bytes
  pipeline    — ``EdgeCloudPipeline.execute`` (Algorithm 2, preagg or raw
                mode) on the segment, pallas or fused backend, and the
                refined fused pass of a fusion group
  session     — ``StreamSession``: registered continuous queries served by
                one sampling pass per fusion group and pane, pane-merged
                sliding/hopping windows, per-query emits, the QoS loop

Typical use::

    table = make_table(*SHENZHEN_BBOX, precision=6)        # on CUDA
    pipe = EdgeCloudPipeline(table, PipelineConfig(backend="pallas"))
    q = Query(aggs=(AggSpec("mean", "value"), AggSpec("max", "value")),
              group_by="neighborhood")
    gen = torch.Generator(device="cuda").manual_seed(0)
    result = pipe.execute(q, gen, window, fraction=0.8)
    result.estimates["mean_value"].value  # (num_neighborhoods,) with MoE
"""

from . import (bounds, codec, estimators, feedback, geohash, pipeline, query, sampling, session,
               stratify, windows)
from .codec import (
    DeltaCodec,
    QuantizeCodec,
    SparseCodec,
    TopKSketchCodec,
    UplinkCodec,
    resolve_codec,
    roundtrip,
)
from .estimators import (
    Accumulator,
    ColumnStats,
    Estimate,
    Extrema,
    Groups,
    QuantileSketch,
    StratumStats,
    accumulate_column,
    accumulator,
    column_stats,
    estimate,
    group_sum,
    groups_of,
    guarded_s2,
    merge_accs,
    merge_accs_panes,
    merge_column_stats,
    merge_column_stats_panes,
    merge_stats,
    psum_stats,
    register_accumulator,
    sample_stats,
    sketch_quantile,
)
from .feedback import SLO, ControllerState, EventPolicy, StackedSLO
from .pipeline import EdgeCloudPipeline, PipelineConfig, WindowResult, edge_sample
from .query import (
    AggEstimate,
    AggSpec,
    FusedPlan,
    Plan,
    Query,
    QueryResult,
    bootstrap_normals,
    finalize,
    finalize_signature,
    fuse,
    fusion_key,
    lower,
    refined_preagg_bytes,
)
from .sampling import SampleResult, compact, edgesos
from .session import PlanDecision, Registration, SessionStep, StreamSession
from .stratify import (
    CHICAGO_BBOX,
    SHENZHEN_BBOX,
    StratumTable,
    make_table,
    make_table_from_codes,
    resolve_device,
)
from .windows import WindowBatch, WindowSpec, count_windows, pane_windows, time_windows

__all__ = [
    "Accumulator",
    "AggEstimate",
    "AggSpec",
    "CHICAGO_BBOX",
    "ColumnStats",
    "ControllerState",
    "DeltaCodec",
    "EdgeCloudPipeline",
    "Estimate",
    "EventPolicy",
    "Extrema",
    "FusedPlan",
    "Groups",
    "PipelineConfig",
    "Plan",
    "PlanDecision",
    "QuantileSketch",
    "QuantizeCodec",
    "Query",
    "QueryResult",
    "Registration",
    "SHENZHEN_BBOX",
    "SLO",
    "SampleResult",
    "SessionStep",
    "SparseCodec",
    "StackedSLO",
    "StratumStats",
    "StratumTable",
    "StreamSession",
    "TopKSketchCodec",
    "UplinkCodec",
    "WindowBatch",
    "WindowResult",
    "WindowSpec",
    "accumulate_column",
    "accumulator",
    "bootstrap_normals",
    "bounds",
    "codec",
    "column_stats",
    "compact",
    "count_windows",
    "edge_sample",
    "edgesos",
    "estimate",
    "estimators",
    "feedback",
    "finalize",
    "finalize_signature",
    "fuse",
    "fusion_key",
    "geohash",
    "group_sum",
    "groups_of",
    "guarded_s2",
    "lower",
    "make_table",
    "make_table_from_codes",
    "merge_accs",
    "merge_accs_panes",
    "merge_column_stats",
    "merge_column_stats_panes",
    "merge_stats",
    "pane_windows",
    "pipeline",
    "psum_stats",
    "query",
    "refined_preagg_bytes",
    "register_accumulator",
    "resolve_codec",
    "resolve_device",
    "roundtrip",
    "sample_stats",
    "sampling",
    "session",
    "sketch_quantile",
    "stratify",
    "time_windows",
    "windows",
]
