from tensornetworkforml_torch.ops.embedding import psi_embed, psi_embed_pair
from tensornetworkforml_torch.ops.contractions import (
    site_mats,
    boundary_vector,
    left_env_stack,
    right_env_stack,
    left_env_stack_parallel,
    right_env_stack_parallel,
    left_env_stack_fused,
    right_env_stack_fused,
    left_env_final,
    right_env_final,
    left_env_final_fused,
    right_env_final_fused,
    chain_scores,
    transfer_suffix_stack,
    transfer_append,
    env_apply_site,
)

__all__ = [
    "psi_embed",
    "psi_embed_pair",
    "site_mats",
    "boundary_vector",
    "left_env_stack",
    "right_env_stack",
    "left_env_stack_parallel",
    "right_env_stack_parallel",
    "left_env_stack_fused",
    "right_env_stack_fused",
    "left_env_final",
    "right_env_final",
    "left_env_final_fused",
    "right_env_final_fused",
    "chain_scores",
    "transfer_suffix_stack",
    "transfer_append",
    "env_apply_site",
    "truncated_svd_split",
]


def __getattr__(name):
    # ops.svd imports utils, whose checkpoints import the models, which import
    # this package: truncated_svd_split is bound at first use, not at import
    if name == "truncated_svd_split":
        from tensornetworkforml_torch.ops.svd import truncated_svd_split

        return truncated_svd_split
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
