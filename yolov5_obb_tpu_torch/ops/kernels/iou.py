"""The exact pair rotated IoU shared by the port's CUDA kernels.

Counterpart of ``yolov5_obb_tpu/ops/pallas/iou_kernel._pairs_iou_math``
(iou_kernel.py:33).  On the card it is the ``__device__`` function
``rotated_pair_iou`` in ``csrc/rotated_iou.cuh``, which the neighbour kernel
(``csrc/neighbor.cu``) calls for each selected pair; its plain version is
:func:`~yolov5_obb_tpu_torch.ops.rotated_iou.pairs_iou_math`.  The JAX
package's standalone pair kernel (``pairs_rotated_iou``) is not on the
inference path and is still to be ported (ROADMAP.md).
"""

from __future__ import annotations

from ..rotated_iou import pairs_iou_math

__all__ = ["pairs_iou_math"]
