from gsvc_tpu_torch.parallel.spmd import (
    combine_slab_renders, make_mesh, make_spmd_train_step, shard_model_state,
)

__all__ = ["make_mesh", "make_spmd_train_step", "shard_model_state",
           "combine_slab_renders"]
