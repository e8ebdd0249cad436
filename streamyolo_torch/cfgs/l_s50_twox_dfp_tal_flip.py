"""StreamYOLO-l, 2x velocity (support t-2, target t+2).

The port's copy of ``cfgs/l_s50_twox_dfp_tal_flip.py``.
"""

from streamyolo_torch.exp import StreamExp


class Exp(StreamExp):
    head_name = "tal"
    dataset_name = "two"
    evaluator_name = "twox"
    tal_gamma = 1.0
    tal_ignore_thr = 0.4
    tal_ignore_value = 1.5

    def __init__(self):
        super().__init__()
        self.depth = 1.0
        self.width = 1.0
