"""What every kind's reference shares: the served-token gap the check
compares.  Each model kind's plain reference (``Reference``) lives in its
own file, ``chipbench/kinds/<kind>.py``."""
from __future__ import annotations

from typing import Sequence

import torch


def served_gaps(logits: torch.Tensor, served: Sequence[int]) -> torch.Tensor:
    """How far each served token's logit lies below the best logit of its
    position (0 where the reference agrees), (n,) f32."""
    t = torch.as_tensor(list(served), dtype=torch.long, device=logits.device)
    return logits.max(-1).values - logits.gather(1, t[:, None])[:, 0]
