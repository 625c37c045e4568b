"""PyTorch/CUDA port of yolov5_obb_tpu: image batch → rotated detections,
and the single-device train step.

The package mirrors the JAX package's module names (``models/yolo.py``,
``models/layers.py``, ``ops/rotated_nms.py``, ``engine/evaluator.py``, ...)
so each counterpart is easy to find.  Activations keep the JAX layouts at
public functions: NHWC feature maps, flat ``(B, n, no)`` Detect maps and the
packed ``(B, H, 3W)`` uint8 image view.

The TPU kernels of the inference and train paths are hand-written CUDA C++
for Hopper (``csrc/``), built with ``nvcc`` at first use
(``ops/kernels/_build.py``).
Each kernel's wrapper keeps a plain PyTorch version beside it; the wrapper
takes the plain version only for tensors on the CPU.

This package imports torch and never jax, nor anything of ``yolov5_obb_tpu``.
"""

__version__ = "0.1.0"
