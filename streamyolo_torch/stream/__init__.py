from streamyolo_torch.stream.clock import SimClock, WallClock
from streamyolo_torch.stream.forecast import (
    KFForecaster,
    Streamer,
    bbox_extrap_lin,
    bbox_extrap_quad,
    extrap_clean_up,
)
from streamyolo_torch.stream.online import (
    CUDAStreamDetector,
    MultiStreamDetector,
    SimulatedDetector,
    export_multi_stream_executables,
    export_stream_executables,
    print_stats,
    run_streaming_detection,
    stream_sequence,
    stream_sequence_infinite,
)
from streamyolo_torch.stream.pairing import (
    detections_for_image,
    eval_ccf,
    ltrb2ltwh,
    pair_streaming_results,
    streaming_eval,
)
from streamyolo_torch.stream.runtime_dist import (
    Empirical,
    add_to_runtime_zoo,
    dist_from_dict,
    dist_from_zoo,
)
from streamyolo_torch.stream.schedule_sim import POLICIES, sim
from streamyolo_torch.stream.track import (
    iou_assoc,
    iou_assoc_no_tracks,
    iou_ltwh,
    track_based_shuffle,
)

__all__ = [
    "SimClock", "WallClock", "CUDAStreamDetector", "MultiStreamDetector",
    "export_stream_executables", "export_multi_stream_executables",
    "SimulatedDetector", "print_stats", "run_streaming_detection",
    "stream_sequence", "stream_sequence_infinite", "detections_for_image",
    "eval_ccf", "ltrb2ltwh", "pair_streaming_results", "streaming_eval",
    "Empirical", "add_to_runtime_zoo", "dist_from_dict", "dist_from_zoo",
    "POLICIES", "sim", "KFForecaster", "Streamer", "bbox_extrap_lin",
    "bbox_extrap_quad", "extrap_clean_up", "iou_assoc", "iou_assoc_no_tracks",
    "iou_ltwh", "track_based_shuffle",
]
