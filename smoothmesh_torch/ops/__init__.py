from smoothmesh_torch.ops.constraints import (  # noqa: F401
    freeze_constraints,
    restrict_edge_shortening,
    restrict_min_edge_angle_decrease,
)
from smoothmesh_torch.ops.smoothing import (  # noqa: F401
    aspect_ratio_smoothing,
    calculate_residual,
    centroidal_smoothing,
    constrain_max_step_length,
    predictor,
)
