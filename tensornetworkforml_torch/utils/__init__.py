from tensornetworkforml_torch.utils.checkpoint import (
    save_checkpoint,
    load_checkpoint,
    save_training_state,
    load_training_state,
    load_any_checkpoint,
    mps_from_numpy,
    boundary_from_numpy,
    save_boundary_checkpoint,
    load_boundary_checkpoint,
    save_boundary_training_state,
    load_boundary_training_state,
)

__all__ = [
    "save_checkpoint",
    "load_checkpoint",
    "save_training_state",
    "load_training_state",
    "load_any_checkpoint",
    "mps_from_numpy",
    "boundary_from_numpy",
    "save_boundary_checkpoint",
    "load_boundary_checkpoint",
    "save_boundary_training_state",
    "load_boundary_training_state",
]
