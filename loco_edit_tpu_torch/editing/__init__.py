from loco_edit_tpu_torch.editing.pullback import (EditBasis, dual_subspace_iteration,
                                                  subspace_iteration)
from loco_edit_tpu_torch.editing.nullspace import null_space_project, normalize_rows
from loco_edit_tpu_torch.editing.walk import x_space_guidance_strip
from loco_edit_tpu_torch.editing.hspace import (global_pca_h, h_to_e, inv_jac,
                                                local_encoder_pullback, local_pca_h)
from loco_edit_tpu_torch.editing.directions import (save_directions, load_directions,
                                                    mask_cache_tag)

__all__ = [
    "EditBasis",
    "subspace_iteration",
    "dual_subspace_iteration",
    "null_space_project",
    "normalize_rows",
    "x_space_guidance_strip",
    "save_directions",
    "load_directions",
    "mask_cache_tag",
    "local_encoder_pullback",
    "h_to_e",
    "inv_jac",
    "global_pca_h",
    "local_pca_h",
]
