from tensornetworkforml_torch.models.mps import (
    MPS,
    mps_init,
    product_init,
    mps_forward,
    apply_act_fn,
    loss_derivative,
    accuracy_from_scores,
)
from tensornetworkforml_torch.models.canonical import (
    canonical_init,
    canonicalize,
    left_canonicalize,
    normalize_label,
    right_canonicalize,
)
from tensornetworkforml_torch.models.network import Network
from tensornetworkforml_torch.models.serving import Predictor

__all__ = [
    "MPS",
    "mps_init",
    "product_init",
    "mps_forward",
    "apply_act_fn",
    "loss_derivative",
    "accuracy_from_scores",
    "Network",
    "Predictor",
    "canonical_init",
    "canonicalize",
    "left_canonicalize",
    "normalize_label",
    "right_canonicalize",
]
