"""``sasrec_step_mfu``: the model operations of the traced steps
(``bounds.sasrec_step_flops``: projections, feed-forward, attention over
the valid causal pairs and the tied head, forward and backward) over the
traced window's seconds times the card's f32-exact peak, in percent."""

from pio_bench.peaks import F32_EXACT_OPS_PER_S


def read(run):
    trace = run.traced
    window = None if trace is None else trace.window_s()
    if not window or "step_flops" not in run.facts:
        return None
    if trace.recorded_steps() != run.tracer.active:
        return None
    return 100.0 * run.facts["step_flops"] / (window * F32_EXACT_OPS_PER_S)
