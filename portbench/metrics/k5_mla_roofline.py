"""K5 at MLA's widths (``flash_attn_bf16_kernel``, one launch a layer): a
launch's bound over its mean device time in the traced window, in %. The
bound is the larger of the launch's operations over the configuration's
peak and its bytes over HBM's, both counted by the reference at the
algorithmic widths (``k5_launch_ops``, ``k5_launch_bytes``: the visible
pairs at qk 192 and v 128; q, k and v read once, o written once). The
trace names the kernel with its template arguments and parameters
(``void (anonymous namespace)::flash_attn_bf16_kernel<256, false>(...)``),
so every entry whose name holds ``KERNEL`` counts. None where the trace
holds no such kernel or the reference counts no launch."""
from portbench.roofline import bound_s

KERNEL = "flash_attn_bf16_kernel"


def read(run):
    ref = run.ref
    if run.trace is None or not hasattr(ref, "k5_launch_ops"):
        return None
    hits = [v for k, v in run.trace["kernels"].items() if KERNEL in k]
    if not hits:
        return None
    total_s = sum(t for t, _ in hits)
    count = sum(n for _, n in hits)
    bound = bound_s(ref.k5_launch_ops(run.config),
                    ref.k5_launch_bytes(run.config), run.peak)
    return 100.0 * bound / (total_s / count)
