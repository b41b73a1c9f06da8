"""Recommender models of the port (the reference's ``repro.models.recsys``)."""
from repro_torch.models.recsys.wide_deep import (
    WideDeepConfig, init_wide_deep, retrieval_scores, wide_deep_logits, wide_deep_loss,
)

__all__ = [
    "WideDeepConfig", "init_wide_deep", "wide_deep_logits", "wide_deep_loss",
    "retrieval_scores",
]
