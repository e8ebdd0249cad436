"""StreamYOLO-s, 1x velocity, DFP + TAL + flip.

The port's copy of ``cfgs/s_s50_onex_dfp_tal_flip.py``.
"""

from streamyolo_torch.exp import StreamExp


class Exp(StreamExp):
    head_name = "tal"
    dataset_name = "one"
    evaluator_name = "onex"
    tal_gamma = 1.0
    tal_ignore_thr = 0.5
    tal_ignore_value = 1.5

    def __init__(self):
        super().__init__()
        self.depth = 0.33
        self.width = 0.50
