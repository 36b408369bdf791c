# The ported core: the set-function protocol, Facility Location (dense and
# matrix-free), Graph Cut (dense and matrix-free), the Disparity family
# (Sum, Min, MinSum), FeatureBased, SetCover, ProbabilisticSetCover, LogDet,
# the clustered mixtures, the information measures (core/info/), the
# similarity kernels with kmeans and the extended V ∪ Q ∪ P kernel, the
# similarity sources (features, dense, k-NN), the gain-backend registry,
# every optimizer (Naive, Lazy, Stochastic and LazierThanLazy greedy, the
# host heap greedy, the cover / knapsack / matroid greedies with their
# Knapsack / PartitionMatroid constraints, SieveStreaming and
# ThresholdGreedy), the SelectionSpec + solve() front door, the batched
# engine and the deprecated maximize() / batched_maximize() shims.
from repro_torch.core.functions.base import SetFunction
from repro_torch.core.functions.clustered import (
    cluster_mask,
    clustered,
    clustered_matrix_free,
)
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
from repro_torch.core.functions.log_det import LogDet, LogDetState
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
from repro_torch.core.optimizers.api import maximize
from repro_torch.core.optimizers.batched import BatchedEngine, batched_maximize, stack_functions
from repro_torch.core.optimizers.constrained import (
    Knapsack,
    PartitionMatroid,
    cover_greedy,
    knapsack_greedy,
    matroid_greedy,
)
from repro_torch.core.optimizers.greedy import (
    GreedyResult,
    lazier_than_lazy_greedy,
    lazy_greedy,
    naive_greedy,
    stochastic_greedy,
)
from repro_torch.core.optimizers.host_lazy import host_lazy_greedy
from repro_torch.core.optimizers.streaming import sieve_streaming, threshold_greedy
from repro_torch.core.optimizers.spec import (
    OptimizerSpec,
    SelectionSpec,
    family_defaults,
    optimizer_names,
    register_family_defaults,
    register_optimizer,
    resolve_optimizer,
    solve,
    wave_capable_names,
)
from repro_torch.core.similarity import (
    build_extended_kernel,
    create_kernel,
    kmeans,
    pairwise_sq_dists,
    sparsify_topk,
)
from repro_torch.core.sources import (
    TILE,
    DenseSource,
    FeatureSource,
    KnnSource,
    dense_source,
    feature_source,
    knn_from_features,
    knn_source,
)
from repro_torch.core.info import (
    FLCG,
    FLCMI,
    FLQMI,
    FLVMI,
    GCMI,
    ConcaveOverModular,
    ConditionedFunction,
    DifferenceFunction,
    gccg,
    gccmi,
    generic_cg,
    generic_cmi,
    generic_mi,
    logdet_cg,
    logdet_cmi,
    logdet_mi,
    psc_cg,
    psc_cmi,
    psc_mi,
    sc_cg,
    sc_cmi,
    sc_mi,
)
