"""StreamYOLO-l, 1x velocity, DFP + TAL + flip (the reference's 'filp' spelling).

The port's copy of ``cfgs/l_s50_onex_dfp_tal_filp.py``.
"""

from streamyolo_torch.exp import StreamExp


class Exp(StreamExp):
    head_name = "tal"
    dataset_name = "one"
    evaluator_name = "onex"
    tal_gamma = 1.0
    tal_ignore_thr = 0.5
    tal_ignore_value = 1.6

    def __init__(self):
        super().__init__()
        self.depth = 1.0
        self.width = 1.0
