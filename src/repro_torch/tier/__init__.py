"""Tiered hot/cold vector store on PyTorch: the counterpart of
`repro.tier`.

Hot nodes keep dense f32 rows resident; cold nodes are demoted to an
int8 scalar-quantized lane (plus the SimHash codes both lanes keep),
with a full-precision rerank of the final candidates.  `TierPolicy`
turns the per-node traversal heat into batched demote/promote moves.
"""

from repro_torch.tier.policy import TierPolicy, tier_maintain
from repro_torch.tier.quant import dequantize_rows, quantize_rows

__all__ = ["TierPolicy", "tier_maintain", "quantize_rows",
           "dequantize_rows"]
