"""StreamYOLO in PyTorch for NVIDIA Hopper (H100).

Counterpart of ``streamyolo_tpu``: the same layout (``nn/``, ``models/``,
``ops/``, ``stream/``, ``utils/``) and names, in PyTorch idiom. The Pallas
kernels of the JAX package are hand-written CUDA kernels here
(``csrc/``), built with ``nvcc`` at first use and bound with ``ctypes``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
