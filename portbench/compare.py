"""The comparison that decides ``correct``: the outputs of the timed path
against the plain reference's, by the rule that the configuration states.

A configuration without a ``"compare"`` block is compared exactly, as the
int8 kinds are (their scores match the reference's bit for bit):

    mismatched_scores          scores that differ from the reference's    <= 0
    scores_compared            scores compared                            >= 1

A configuration with ``"compare": {"atol": a, "rtol": r,
"max_relative_rms": m, "why": "..."}`` (a float model against its float32
reference) is compared within that tolerance:

    scores_outside_tolerance   |out - want| > a + r·|want|, or either of
                               the two not finite                         <= 0
    relative_rms_error         ||out - want||_2 / ||want||_2 over every
                               score compared; null where not finite      <= m
    scores_compared            scores compared                            >= 1

``correct`` holds where every check holds. The reference runs inside
``no_tf32``: its float32 products in float32, whatever the program's own
process allows.
"""
from __future__ import annotations

import contextlib
import math
import numbers
import operator
from typing import Iterable, Optional, Tuple

import torch

TOLERANCE = ("atol", "rtol", "max_relative_rms")
HOLDS = {"value <= limit": operator.le, "value >= limit": operator.ge}


def check_rule(rule: dict) -> dict:
    """``rule`` (a configuration's ``"compare"`` block), or ValueError where
    a number is missing, not a number or negative, ``why`` is missing or
    empty, or a key is unknown."""
    if not isinstance(rule, dict):
        raise ValueError(f'"compare" is not an object: {rule!r}')
    unknown = set(rule) - set(TOLERANCE) - {"why"}
    if unknown:
        raise ValueError(f'"compare" has unknown keys {sorted(unknown)}')
    for key in TOLERANCE:
        v = rule.get(key)
        if (not isinstance(v, numbers.Real) or isinstance(v, bool)
                or not math.isfinite(v) or v < 0):
            raise ValueError(f'"compare" needs "{key}" as a number >= 0, '
                             f'not {v!r}')
    why = rule.get("why")
    if not isinstance(why, str) or not why.strip():
        raise ValueError('"compare" needs a "why"')
    return rule


def _check(value, limit, holds_if: str) -> dict:
    return {"value": value, "limit": limit, "holds_if": holds_if}


def checks(pairs: Iterable[Tuple[torch.Tensor, torch.Tensor]],
           rule: Optional[dict] = None) -> dict:
    """The checks over ``(out, want)`` pairs, by ``rule`` (exact where
    None); ``out`` is moved to ``want``'s device."""
    if rule is None:
        differ = compared = 0
        for out, want in pairs:
            differ += int((out.to(want.device) != want).sum())
            compared += want.numel()
        return {"mismatched_scores": _check(differ, 0, "value <= limit"),
                "scores_compared": _check(compared, 1, "value >= limit")}
    outside = compared = 0
    err2 = ref2 = 0.0
    for out, want in pairs:
        w = want.to(torch.float64)
        o = out.to(want.device, torch.float64)
        d = (o - w).abs()
        within = (torch.isfinite(o) & torch.isfinite(w)
                  & (d <= rule["atol"] + rule["rtol"] * w.abs()))
        outside += int((~within).sum())
        compared += want.numel()
        err2 += float((d * d).sum())
        ref2 += float((w * w).sum())
    if ref2 > 0:
        rel = math.sqrt(err2) / math.sqrt(ref2)
    else:
        rel = 0.0 if err2 == 0 else math.inf
    return {"scores_outside_tolerance": _check(outside, 0, "value <= limit"),
            "relative_rms_error": _check(rel if math.isfinite(rel) else None,
                                         rule["max_relative_rms"],
                                         "value <= limit"),
            "scores_compared": _check(compared, 1, "value >= limit")}


def holds(check: dict) -> bool:
    return (check["value"] is not None
            and HOLDS[check["holds_if"]](check["value"], check["limit"]))


def correct(found: dict) -> bool:
    return all(holds(c) for c in found.values())


@contextlib.contextmanager
def no_tf32():
    """TF32 off for cuBLAS and cuDNN inside, each flag restored after."""
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    was = matmul.allow_tf32, cudnn.allow_tf32
    matmul.allow_tf32 = cudnn.allow_tf32 = False
    try:
        yield
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = was
