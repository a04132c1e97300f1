# The paper's primary contribution: personalized, fully decentralized
# learning via asynchronous block coordinate descent over an agent graph
# (Bellet, Guerraoui, Taziki, Tommasi, 2017) — the PyTorch port.
from repro_torch.core.graph import (
    AgentGraph,
    CSRGraph,
    angular_similarity_graph,
    as_csr,
    as_dense,
    circulant_graph,
    complete_graph,
    confidences,
    csr_from_coo,
    dense_weights,
    erdos_renyi_graph,
    knn_cosine_graph,
    knn_graph,
    neighbor_counts,
    random_geometric_graph,
    ring_graph,
    sparse_crossover,
)
from repro_torch.core.mixing import MixOp, mix_op
from repro_torch.core.objective import (
    LOGISTIC,
    LOSSES,
    QUADRATIC,
    AgentData,
    Loss,
    Objective,
    make_objective,
)
from repro_torch.core.coordinate_descent import (
    CDResult,
    proposition1_bound,
    run,
    run_scan,
    sample_wake_sequence,
    synchronous_round,
)
from repro_torch.core.privacy import (
    PrivacyAccountant,
    compose_kairouz,
    compose_uniform,
    gaussian_scale,
    invert_uniform_budget,
    laplace_scale,
    proposition2_allocation,
    schedule_renormalization,
    theorem2_bound,
    uniform_noise_limit,
)
from repro_torch.core.dp_cd import DPCDResult, DPConfig, run_private
from repro_torch.core.admm_baseline import ADMMResult, run_admm
from repro_torch.core.local_dp import perturb_dataset
from repro_torch.core.model_propagation import (
    private_local_models,
    private_warm_start,
    propagation_objective,
    run_propagation,
    train_local_models,
)

__all__ = [k for k in dir() if not k.startswith("_")]
