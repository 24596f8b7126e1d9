from tensornetworkforml_torch.models.mps import (
    MPS,
    mps_init,
    product_init,
    mps_forward,
    apply_act_fn,
    loss_derivative,
    accuracy_from_scores,
)
from tensornetworkforml_torch.models.ensemble import (
    EnsembleMPS,
    ensemble_accuracy,
    ensemble_forward,
    ensemble_init,
    to_direct_sum,
)
from tensornetworkforml_torch.models.serving import Predictor
from tensornetworkforml_torch.models.boundary import (
    BoundaryMPS,
    boundary_forward,
    boundary_product_init,
    grow_boundary_bond,
)
from tensornetworkforml_torch.models.ring import (
    ring_forward,
    ring_product_init,
    ring_trainer,
)
from tensornetworkforml_torch.models.network import Network
from tensornetworkforml_torch.models.canonical import (
    canonical_init,
    canonicalize,
    left_canonicalize,
    normalize_label,
    right_canonicalize,
)

__all__ = [
    "product_init",
    "EnsembleMPS",
    "ensemble_accuracy",
    "ensemble_forward",
    "ensemble_init",
    "to_direct_sum",
    "BoundaryMPS",
    "boundary_forward",
    "boundary_product_init",
    "grow_boundary_bond",
    "Predictor",
    "ring_forward",
    "ring_product_init",
    "ring_trainer",
    "canonical_init",
    "canonicalize",
    "left_canonicalize",
    "normalize_label",
    "right_canonicalize",
    "MPS",
    "mps_init",
    "mps_forward",
    "apply_act_fn",
    "loss_derivative",
    "accuracy_from_scores",
    "Network",
]
