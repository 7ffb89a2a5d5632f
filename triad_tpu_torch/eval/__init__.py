"""Evaluation of the port: the 1000-way cross-modal retrieval."""

from triad_tpu_torch.eval.retrieval import (
    at_retrieval_metrics,
    av_retrieval_metrics,
    compute_recall_at_k,
    embed_av_subset,
    embed_tv_subset,
    eval_1000_way_retrieval,
    score_matrix,
    select_subset_indices,
    tv_retrieval_metrics,
)

__all__ = [
    "at_retrieval_metrics",
    "av_retrieval_metrics",
    "compute_recall_at_k",
    "embed_av_subset",
    "embed_tv_subset",
    "eval_1000_way_retrieval",
    "score_matrix",
    "select_subset_indices",
    "tv_retrieval_metrics",
]
