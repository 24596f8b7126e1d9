from tensornetworkforml_torch.train.sweep import (
    SweepConfig,
    sweep_once,
    train_batch,
    two_site_update,
)
from tensornetworkforml_torch.train.epoch import fused_epoch
from tensornetworkforml_torch.train.factored_step import (
    factored_supported,
    two_site_update_factored,
)
from tensornetworkforml_torch.train.trainer import (
    Trainer,
    evaluate_accuracy,
    stall_detected,
    train_model,
)
from tensornetworkforml_torch.train.autodiff import (
    AutodiffConfig,
    AutodiffTrainer,
    BoundaryAutodiffTrainer,
)
from tensornetworkforml_torch.train.onesite import (
    OneSiteConfig,
    onesite_sweep,
    train_boundary_model,
)
from tensornetworkforml_torch.train.brickwall import (
    BrickConfig,
    brick_sweep,
    train_brickwall,
)

__all__ = [
    "SweepConfig",
    "sweep_once",
    "train_batch",
    "two_site_update",
    "fused_epoch",
    "factored_supported",
    "two_site_update_factored",
    "Trainer",
    "evaluate_accuracy",
    "stall_detected",
    "train_model",
    "AutodiffConfig",
    "AutodiffTrainer",
    "BoundaryAutodiffTrainer",
    "OneSiteConfig",
    "onesite_sweep",
    "train_boundary_model",
    "BrickConfig",
    "brick_sweep",
    "train_brickwall",
]
