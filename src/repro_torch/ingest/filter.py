"""Two-stage filtering (§II-A Filter).

Stage 1 is the source-API filter (keyword list passed to the streaming
API — here applied to the synthetic stream the same way Twitter would).
Stage 2 is the analysis-specific filter (e.g. drop records that carry
no graph signal, the paper's "remove tweets with only emojis").
"""
from __future__ import annotations

from typing import Callable, Iterable, List, Sequence


def api_keyword_filter(keywords: Sequence[str]) -> Callable[[dict], bool]:
    kws = [k.lower() for k in keywords]

    def f(rec: dict) -> bool:
        if not kws:
            return True
        hay = " ".join(
            [rec.get("text", "")] + list(rec.get("hashtags", ()))
        ).lower()
        return any(k in hay for k in kws)

    return f


def analysis_filter(rec: dict) -> bool:
    """Drop records with no graph content (no hashtags AND no mentions
    -> only the owner edge; keep those, but drop empty/malformed)."""
    return bool(rec.get("id")) and bool(rec.get("user"))


def apply_filters(records: Iterable[dict], stage1, stage2=analysis_filter) -> List[dict]:
    return [r for r in records if stage1(r) and stage2(r)]
