"""StreamYOLO-l, still-frame (offline AP) variant: PIPE head, STILL dataset and evaluator.

The port's copy of ``cfgs/l_s50_still_dfp_flip.py``.
"""

from streamyolo_torch.exp import StreamExp


class Exp(StreamExp):
    head_name = "pipe"
    dataset_name = "still"
    evaluator_name = "still"

    def __init__(self):
        super().__init__()
        self.depth = 1.0
        self.width = 1.0
