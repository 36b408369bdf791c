# The ported core: the set-function protocol, Facility Location (dense and
# matrix-free), Graph Cut (dense and matrix-free), the Disparity family
# (Sum, Min, MinSum), FeatureBased, SetCover and ProbabilisticSetCover (with
# their information measures in core/info/), the similarity sources, the
# gain-backend registry, NaiveGreedy / LazyGreedy and the SelectionSpec +
# solve() front door (sequential mode).
from repro_torch.core.functions.base import SetFunction
from repro_torch.core.functions.disparity import (
    DisparityMin,
    DisparityMinSum,
    DisparitySum,
    DMinState,
    DMinSumState,
    DSumState,
)
from repro_torch.core.functions.facility_location import (
    FacilityLocation,
    FacilityLocationMF,
    FLState,
)
from repro_torch.core.functions.feature_based import FBState, FeatureBased
from repro_torch.core.functions.graph_cut import GCState, GraphCut, GraphCutMF
from repro_torch.core.functions.set_cover import (
    ProbabilisticSetCover,
    PSCState,
    SCState,
    SetCover,
)
from repro_torch.core.optimizers.backends import (
    GainBackend,
    backend_name,
    choose_backend,
    full_sweep,
    kernel_enabled,
    partial_sweep,
    register_gain_backend,
    resolve_backend,
)
from repro_torch.core.optimizers.greedy import GreedyResult, lazy_greedy, naive_greedy
from repro_torch.core.optimizers.spec import (
    OptimizerSpec,
    SelectionSpec,
    family_defaults,
    optimizer_names,
    register_family_defaults,
    register_optimizer,
    resolve_optimizer,
    solve,
)
from repro_torch.core.similarity import create_kernel, pairwise_sq_dists, sparsify_topk
from repro_torch.core.sources import (
    TILE,
    DenseSource,
    FeatureSource,
    dense_source,
    feature_source,
)
