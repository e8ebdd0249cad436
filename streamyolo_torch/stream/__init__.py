from streamyolo_torch.stream.clock import SimClock, WallClock
from streamyolo_torch.stream.online import (
    CUDAStreamDetector,
    MultiStreamDetector,
    SimulatedDetector,
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

__all__ = [
    "SimClock", "WallClock", "CUDAStreamDetector", "MultiStreamDetector",
    "SimulatedDetector", "print_stats", "run_streaming_detection",
    "stream_sequence", "stream_sequence_infinite", "detections_for_image",
    "eval_ccf", "ltrb2ltwh", "pair_streaming_results", "streaming_eval",
    "Empirical", "add_to_runtime_zoo", "dist_from_dict", "dist_from_zoo",
]
