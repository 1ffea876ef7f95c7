"""Plain PyTorch version of the l1_topk kernel (``csrc/l1_topk.cu``)."""
from __future__ import annotations

from repro_torch.core.topk import masked_l1_topk_batch as l1_topk_ref  # noqa: F401
