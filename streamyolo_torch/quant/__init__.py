"""Int8 post-training quantization for serving (the TensorRT-int8 slot)."""

from streamyolo_torch.quant.ptq import (
    calibrate_activations,
    flax_module_path,
    quantize_for_serving,
    quantize_state_dict,
)

__all__ = ["calibrate_activations", "flax_module_path", "quantize_for_serving",
           "quantize_state_dict"]
