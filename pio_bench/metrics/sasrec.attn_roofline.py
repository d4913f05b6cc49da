"""``sasrec.attn_roofline``: the least time of B4 and the fused backward
(``bounds.flash_bound`` of each launch of the traced steps, on each
step's own batch and causal pairs) over their device time, the kernels
named ``flash_fwd`` and ``flash_bwd`` in the profiler's trace, in
percent. Nothing is read unless every launch is in the trace."""


def read(run):
    trace = run.traced
    if trace is None or "attn_bound_s" not in run.facts:
        return None
    kernels = trace.kernels("flash_fwd", "flash_bwd")
    if len(kernels) != run.facts["attn_launches"]:
        return None
    seconds = trace.seconds(kernels)
    return None if seconds <= 0 else 100.0 * run.facts["attn_bound_s"] / seconds
