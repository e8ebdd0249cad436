from streamyolo_torch.ops.nms import (
    candidate_counts,
    nms_keep,
    nms_padded,
    nms_padded_sequential,
    postprocess,
    postprocess_fixed,
    select_candidates,
    warn_if_saturated,
)
from streamyolo_torch.ops.preproc import downsample2x, downsample2x_plain, downsample2x_reference
from streamyolo_torch.ops.resize import resize_nearest

__all__ = ["candidate_counts", "downsample2x", "downsample2x_plain",
           "downsample2x_reference", "nms_keep", "nms_padded",
           "nms_padded_sequential", "postprocess", "postprocess_fixed",
           "resize_nearest", "select_candidates", "warn_if_saturated"]
