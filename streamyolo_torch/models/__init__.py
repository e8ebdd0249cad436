from streamyolo_torch.models.darknet import CSPDarknet, Darknet
from streamyolo_torch.models.dfp_pafpn import DFPPAFPN
from streamyolo_torch.models.heads import PIPEHead, TALHead, YOLOXHead
from streamyolo_torch.models.yolox import YOLOX, StreamYOLO, build_streamyolo, init_weights

__all__ = ["CSPDarknet", "Darknet", "DFPPAFPN", "PIPEHead", "TALHead", "YOLOXHead",
           "YOLOX", "StreamYOLO", "build_streamyolo", "init_weights"]
