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
  windows     — count-triggered tumbling windows with named value columns
  query       — ``Query``/``AggSpec`` specs lowered to plans, plan fusion,
                and finalize
  pipeline    — ``EdgeCloudPipeline.execute`` (Algorithm 2, preagg mode) on
                the segment, pallas or fused backend, and the refined fused
                pass of a fusion group

Typical use::

    table = make_table(*SHENZHEN_BBOX, precision=6)        # on CUDA
    pipe = EdgeCloudPipeline(table, PipelineConfig(backend="pallas"))
    q = Query(aggs=(AggSpec("mean", "value"), AggSpec("max", "value")),
              group_by="neighborhood")
    gen = torch.Generator(device="cuda").manual_seed(0)
    result = pipe.execute(q, gen, window, fraction=0.8)
    result.estimates["mean_value"].value  # (num_neighborhoods,) with MoE
"""

from . import bounds, estimators, geohash, pipeline, query, sampling, stratify, windows
from .estimators import (
    Accumulator,
    Estimate,
    Extrema,
    Groups,
    QuantileSketch,
    StratumStats,
    accumulator,
    estimate,
    group_sum,
    groups_of,
    guarded_s2,
    merge_stats,
    register_accumulator,
    sample_stats,
    sketch_quantile,
)
from .pipeline import EdgeCloudPipeline, PipelineConfig, edge_sample
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
from .sampling import SampleResult, edgesos
from .stratify import (
    CHICAGO_BBOX,
    SHENZHEN_BBOX,
    StratumTable,
    make_table,
    make_table_from_codes,
    resolve_device,
)
from .windows import WindowBatch, count_windows

__all__ = [
    "CHICAGO_BBOX",
    "SHENZHEN_BBOX",
    "Accumulator",
    "AggEstimate",
    "AggSpec",
    "EdgeCloudPipeline",
    "Estimate",
    "Extrema",
    "FusedPlan",
    "Groups",
    "PipelineConfig",
    "Plan",
    "QuantileSketch",
    "Query",
    "QueryResult",
    "SampleResult",
    "StratumStats",
    "StratumTable",
    "WindowBatch",
    "accumulator",
    "bootstrap_normals",
    "bounds",
    "count_windows",
    "edge_sample",
    "edgesos",
    "estimate",
    "estimators",
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
    "merge_stats",
    "pipeline",
    "query",
    "refined_preagg_bytes",
    "register_accumulator",
    "resolve_device",
    "sample_stats",
    "sampling",
    "sketch_quantile",
    "stratify",
    "windows",
]
