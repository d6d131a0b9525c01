"""The sort library's public surface (PyTorch / CUDA port).

The baselines stay namespaced (``repro_torch.core.baselines``), as in
the JAX package; so do the cost model and the autotuner, exported as
modules.
"""

from repro_torch.core import autotune, cost_model
from repro_torch.core.bucket_sort import (
    argsort,
    argsort_batched,
    resolve_plan,
    segment_argsort,
    segment_sort,
    sort,
    sort_batched,
    sort_batched_with_stats,
    sort_kv,
    sort_kv_batched,
    sort_planned,
    sort_with_stats,
)
from repro_torch.core.distributed_sort import (
    DistSortSpec,
    make_sharded_sort,
    shard_runner,
    sorted_shard,
)
from repro_torch.core.faults import FaultInjected
from repro_torch.core.guard import (
    CHECK_MODES,
    DegradationEvent,
    DegradationWarning,
    SortRuntimeError,
    clear_degradation_log,
    degradation_log,
)
from repro_torch.core.key_codec import SUPPORTED_DTYPES, KeyCodec, codec_for
from repro_torch.core.partial_sort import topk, topk_batched
from repro_torch.core.probe import priors_for, probed_config, recommend_strategy
from repro_torch.core.plan import (
    LevelPlan,
    ShardGeometry,
    ShardPlan,
    SortPlan,
    TopkPlan,
    build_plan,
    build_shard_plan,
    build_topk_plan,
    build_words_plan,
    config_fingerprint,
    shard_geometry,
)
from repro_torch.core.sort_config import DEFAULT_CONFIG, PAPER_CONFIG, SortConfig

__all__ = [
    "autotune",
    "cost_model",
    "argsort",
    "argsort_batched",
    "resolve_plan",
    "segment_argsort",
    "segment_sort",
    "sort",
    "sort_batched",
    "sort_batched_with_stats",
    "sort_kv",
    "sort_kv_batched",
    "sort_planned",
    "sort_with_stats",
    "topk",
    "topk_batched",
    "DistSortSpec",
    "make_sharded_sort",
    "shard_runner",
    "sorted_shard",
    "CHECK_MODES",
    "DegradationEvent",
    "DegradationWarning",
    "FaultInjected",
    "SortRuntimeError",
    "clear_degradation_log",
    "degradation_log",
    "KeyCodec",
    "SUPPORTED_DTYPES",
    "codec_for",
    "LevelPlan",
    "ShardGeometry",
    "ShardPlan",
    "SortPlan",
    "TopkPlan",
    "build_plan",
    "build_shard_plan",
    "build_topk_plan",
    "build_words_plan",
    "config_fingerprint",
    "shard_geometry",
    "priors_for",
    "probed_config",
    "recommend_strategy",
    "DEFAULT_CONFIG",
    "PAPER_CONFIG",
    "SortConfig",
]
