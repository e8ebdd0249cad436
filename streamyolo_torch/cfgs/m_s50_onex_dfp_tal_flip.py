"""StreamYOLO-m, 1x velocity, DFP + TAL + flip.

The port's copy of ``cfgs/m_s50_onex_dfp_tal_flip.py``.
"""

from streamyolo_torch.exp import StreamExp


class Exp(StreamExp):
    head_name = "tal"
    dataset_name = "one"
    evaluator_name = "onex"
    tal_gamma = 1.0
    tal_ignore_thr = 0.4
    tal_ignore_value = 1.7

    def __init__(self):
        super().__init__()
        self.depth = 0.67
        self.width = 0.75
