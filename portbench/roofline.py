"""Peaks of the card (NVIDIA data sheets, dense rates, at the full power
limit) and the least time a launch could take."""
from __future__ import annotations

from typing import Optional

# name as torch.cuda.get_device_name() gives it -> operations a second by
# the precision of the operands, and HBM bytes a second. H100 SXM5: the
# dense tensor-core rates (the data sheet's figures with sparsity, halved).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "ops": {"int8": 1979e12, "bf16": 989.4e12},
        "bytes": 3.35e12},
}


def peaks(device_name: str, precision: str):
    """(operations a second at ``precision``, bytes a second) of the named
    card; raises for a card or a precision whose peak is not in the table,
    since no share could be stated."""
    try:
        card = PEAKS[device_name]
    except KeyError:
        raise ValueError(f"no data-sheet peaks for {device_name!r}") from None
    try:
        return card["ops"][precision], card["bytes"]
    except KeyError:
        raise ValueError(f"no data-sheet {precision!r} peak for "
                         f"{device_name!r}") from None


def bound_s(ops: float, nbytes: float, peak) -> float:
    """max(operations / the precision's peak, bytes / HBM bandwidth), in
    seconds, ``peak`` as ``peaks`` gives it."""
    return max(ops / peak[0], nbytes / peak[1])


def kernel_share(run, kernel: str) -> Optional[float]:
    """A launch's bound over ``kernel``'s mean device time a launch, in %,
    where every batch is one launch of it; None where the trace holds no
    such kernel. Operations and bytes are counted from the batch's shapes:
    each event read once, its scores written once, the weights once."""
    if run.trace is None or kernel not in run.trace["kernels"]:
        return None
    total_s, count = run.trace["kernels"][kernel]
    ref = run.ref
    n = run.batch_events
    bound = bound_s(n * ref.ops_per_event(run.config),
                    n * ref.bytes_per_event(run.config)
                    + ref.weight_bytes(run.config), run.peak)
    return 100.0 * bound / (total_s / count)
