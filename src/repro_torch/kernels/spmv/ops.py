"""Public SpMV kernel op: dispatches the blocked-ELL and CSR-stripe kernels;
device policy and the ragged last block live in the kernel wrappers."""
from __future__ import annotations

import torch

from .kernel import spmv_ell
from .stripe import StripePlan, build_stripe_plan, spmv_ell_stripes

#: dense-ELL padding overhead at which the auto variant flips to stripes:
#: below this the blocked kernel's single launch wins, above it a skewed
#: matrix is mostly executing padding
STRIPE_WASTE_THRESHOLD = 2.0


def spmv(
    cols: torch.Tensor,
    vals: torch.Tensor,
    x: torch.Tensor,
    *,
    grain: int = 256,
    variant: str = "ell",
    stripe_plan: "StripePlan | None" = None,
) -> torch.Tensor:
    """y = A @ x for padded-ELL A.

    ``grain`` = rows per CUDA block (the paper's grain size, Fig. 4).
    ``variant``: ``"ell"`` (blocked, one launch), ``"stripe"`` (sliced-ELL
    per-stripe widths for skewed rows), or ``"auto"`` (stripe when the
    dense-ELL padding waste reaches ``STRIPE_WASTE_THRESHOLD``).
    """
    r, _ = cols.shape
    g = max(1, min(grain, r))
    if variant == "auto":
        plan = stripe_plan if stripe_plan is not None else build_stripe_plan(cols, g)
        variant = "stripe" if plan.waste_ratio >= STRIPE_WASTE_THRESHOLD else "ell"
        stripe_plan = plan
    if variant == "stripe":
        return spmv_ell_stripes(cols, vals, x, block_rows=g, plan=stripe_plan)
    if variant != "ell":
        raise ValueError(f"unknown spmv variant {variant!r}: ell | stripe | auto")
    return spmv_ell(cols, vals, x, block_rows=g)
